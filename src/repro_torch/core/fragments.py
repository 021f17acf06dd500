"""Fragment geometry for FORMS polarized crossbar mapping.

A *fragment* is the set of ``m`` consecutive weights of one column of the
``(K, N)`` crossbar matrix (paper §III-B).  Fragments partition the K axis
into ``ceil(K / m)`` groups; when ``K % m != 0`` the matrix is zero-padded
and the pad rows never count against polarization.  Conv kernels
``(H, W, C_in, C_out)`` reshape to ``(H*W*C_in, C_out)`` under a row-order
policy (W-, H- or C-major, paper Fig 3).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Policy = str  # "W" | "H" | "C"

VALID_POLICIES = ("W", "H", "C")


@dataclasses.dataclass(frozen=True)
class FragmentSpec:
    """Static description of how a weight tensor is fragmented.

    Attributes:
      m: fragment size == rows per logical sub-array column (paper: 4/8/16).
      policy: row-ordering policy for conv weights ("W", "H" or "C" major).
      n_sub_cols: columns per logical sub-array (crossbar mapping only).
    """

    m: int = 8
    policy: Policy = "W"
    n_sub_cols: int = 128

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"fragment size must be >= 1, got {self.m}")
        if self.policy not in VALID_POLICIES:
            raise ValueError(f"policy must be one of {VALID_POLICIES}, got {self.policy!r}")

    def num_fragments(self, k: int) -> int:
        return -(-k // self.m)

    def padded_k(self, k: int) -> int:
        return self.num_fragments(k) * self.m


def conv_to_matrix(w: torch.Tensor, policy: Policy = "W") -> torch.Tensor:
    """Reshape a conv kernel ``(H, W, C_in, C_out)`` to the 2-D crossbar matrix
    (W-major: rows (h, c, w); H-major: (w, c, h); C-major: (h, w, c))."""
    if w.ndim == 2:
        return w
    if w.ndim != 4:
        raise ValueError(f"expected 2-D or 4-D weight, got shape {tuple(w.shape)}")
    h, ww, cin, cout = w.shape
    if policy == "W":
        m = w.permute(0, 2, 1, 3)
    elif policy == "H":
        m = w.permute(1, 2, 0, 3)
    elif policy == "C":
        m = w
    else:
        raise ValueError(policy)
    return m.reshape(h * ww * cin, cout)


def matrix_to_conv(mat: torch.Tensor, shape: Tuple[int, int, int, int],
                   policy: Policy = "W") -> torch.Tensor:
    """Inverse of :func:`conv_to_matrix`."""
    h, ww, cin, cout = shape
    if policy == "W":
        return mat.reshape(h, cin, ww, cout).permute(0, 2, 1, 3)
    if policy == "H":
        return mat.reshape(ww, cin, h, cout).permute(2, 0, 1, 3)
    if policy == "C":
        return mat.reshape(h, ww, cin, cout)
    raise ValueError(policy)


def pad_rows(mat: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad the K axis of ``(K, N)`` to a multiple of the fragment size."""
    pad = (-mat.shape[0]) % m
    if pad == 0:
        return mat
    return torch.nn.functional.pad(mat, (0, 0, 0, pad))


def to_fragments(mat: torch.Tensor, m: int) -> torch.Tensor:
    """View ``(K, N)`` as ``(F, m, N)`` fragments (zero-padding K as needed);
    a stack ``(L, K, N)`` becomes ``(L, F, m, N)``."""
    mat = pad_rows(mat, m)
    k, n = mat.shape[-2:]
    return mat.reshape(*mat.shape[:-2], k // m, m, n)


def expand_fragment_values(values: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Broadcast per-fragment values ``(F, N)`` to per-weight ``(K, N)``
    (and ``(L, F, N)`` to ``(L, K, N)``)."""
    return values.repeat_interleave(m, dim=-2)[..., :k, :]


def is_crossbar_weight(path: str, shape: Tuple[int, ...]) -> bool:
    """Heuristic: does this parameter map onto crossbar cells?

    Matmul weights (rank 2 with both dims > 1), scan-stacked matmul weights
    (rank 3: (L, in, out)) and conv kernels (rank 4) are crossbar-mapped.
    Biases, norms, per-channel recurrence params (rank 0/1) are digital-domain
    and excluded; embedding tables are lookups, not MVMs — excluded by name.
    The name list is the JAX package's, verbatim.
    """
    lname = path.lower()
    if any(t in lname for t in ("embed", "bias", "scale", "norm", "a_log",
                                "dt_", "conv_w", "conv_b", "conv1d", "lambda",
                                "d_skip", "/bf", "/ro", "/rz", "/ri", "/rf",
                                # QKV / MLP bias vectors (scan-stacked they are
                                # rank 2 but are digital-domain, not MVMs)
                                "/bq", "/bk", "/bv", "b_up", "b_down")):
        return False
    if len(shape) in (3, 4):
        return True
    if len(shape) == 2 and shape[0] > 1 and shape[1] > 1:
        return True
    return False
