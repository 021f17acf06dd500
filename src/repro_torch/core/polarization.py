"""Fragment polarization: sign rules and the Euclidean projection onto P.

``sum``    — the paper's rule (Eq. 2): ``s_f = +`` iff ``sum(V_f) >= 0``.
``energy`` — the exact projection: keep the sign whose entries carry more
             squared mass.
``frozen`` — keep externally supplied signs.

The ``sum`` and ``energy`` projections run through
:func:`repro_torch.kernels.ops.admm_polarize`: the CUDA kernel on the card,
its plain version on the CPU.  Both add a fragment's rows in row order, so
the signs equal the reference's bit for bit.  ``frozen`` is plain torch (the
kernel has no frozen mode, as the Pallas one has none).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import fragments as frag
from repro_torch.kernels import ops as kops

SIGN_RULES = ("sum", "energy", "frozen")


def fragment_signs(mat: torch.Tensor, m: int, rule: str = "sum") -> torch.Tensor:
    """Per-fragment signs in {+1, -1}, shape ``(F, N)`` for a ``(K, N)`` matrix
    (or ``(L, F, N)`` for a stack), in mat's dtype."""
    return kops.admm_polarize(mat, m=m, rule=rule)[1]


def project_polarize(mat: torch.Tensor, m: int, rule: str = "sum",
                     signs: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean projection of ``(K, N)`` (or a stack ``(L, K, N)``) onto the
    polarized set P.

    Returns ``(projected, signs)`` with ``signs`` of shape ``(F, N)`` (or
    ``(L, F, N)``).  If ``rule == 'frozen'`` the caller must pass ``signs``.
    """
    if rule != "frozen":
        return kops.admm_polarize(mat, m=m, rule=rule)
    if signs is None:
        raise ValueError("rule='frozen' requires signs")
    sign_grid = frag.expand_fragment_values(signs, m, mat.shape[-2])
    projected = torch.where(mat * sign_grid >= 0, mat, torch.zeros_like(mat))
    return projected, signs


def polarization_violation(mat: torch.Tensor, m: int,
                           signs: Optional[torch.Tensor] = None,
                           rule: str = "sum") -> torch.Tensor:
    """Fraction of weight *magnitude* violating the fragment sign (0 = feasible);
    one fraction per layer of a stack (L, K, N)."""
    if signs is None:
        signs = fragment_signs(mat, m, rule)
    sign_grid = frag.expand_fragment_values(signs, m, mat.shape[-2])
    bad = torch.where(mat * sign_grid < 0, mat.abs(), torch.zeros_like(mat))
    tot = mat.abs().sum(dim=(-2, -1))
    return bad.sum(dim=(-2, -1)) / torch.clamp(tot, min=1e-12)


def violation_sums(mat: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two sums of :func:`polarization_violation` (freshly elected
    signs): the magnitude that disagrees with its fragment's sign and the
    whole magnitude, per layer of a stack; a shard's, to be summed over
    the ranks that split the matrix."""
    signs = fragment_signs(mat, m)
    sign_grid = frag.expand_fragment_values(signs, m, mat.shape[-2])
    bad = torch.where(mat * sign_grid < 0, mat.abs(), torch.zeros_like(mat))
    return bad.sum(dim=(-2, -1)), mat.abs().sum(dim=(-2, -1))


def is_polarized(mat: torch.Tensor, m: int) -> torch.Tensor:
    """Boolean: every fragment's nonzeros share one sign."""
    frs = frag.to_fragments(mat, m)
    has_pos = (frs > 0).any(dim=-2)
    has_neg = (frs < 0).any(dim=-2)
    return ~(has_pos & has_neg).any()


def decompose_polarized(mat: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a polarized matrix into (magnitudes >= 0, fragment signs): the
    FORMS storage format (magnitudes on the crossbar, one sign bit per
    fragment in the sign indicator, §IV-A).  An all-zero fragment gets +1."""
    frs = frag.to_fragments(mat, m)
    has_neg = (frs < 0).any(dim=-2)
    one = torch.ones((), dtype=mat.dtype, device=mat.device)
    signs = torch.where(has_neg, -one, one)
    sign_grid = frag.expand_fragment_values(signs, m, mat.shape[-2])
    return mat * sign_grid, signs


def recompose_polarized(mags: torch.Tensor, signs: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`decompose_polarized`."""
    return mags * frag.expand_fragment_values(signs, m, mags.shape[-2])
