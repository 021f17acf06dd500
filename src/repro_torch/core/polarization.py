"""Fragment polarization: sign rules and the Euclidean projection onto P.

``sum``    — the paper's rule (Eq. 2): ``s_f = +`` iff ``sum(V_f) >= 0``.
``energy`` — the exact projection: keep the sign whose entries carry more
             squared mass.
``frozen`` — keep externally supplied signs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import fragments as frag

SIGN_RULES = ("sum", "energy", "frozen")


def fragment_signs(mat: torch.Tensor, m: int, rule: str = "sum") -> torch.Tensor:
    """Per-fragment signs in {+1, -1}, shape ``(F, N)`` for a ``(K, N)`` matrix."""
    frs = frag.to_fragments(mat, m)  # (F, m, N)
    one = torch.ones((), dtype=mat.dtype, device=mat.device)
    if rule == "sum":
        s = frs.sum(dim=1)
        return torch.where(s >= 0, one, -one)
    if rule == "energy":
        pos_e = torch.square(torch.clamp(frs, min=0.0)).sum(dim=1)
        neg_e = torch.square(torch.clamp(frs, max=0.0)).sum(dim=1)
        return torch.where(pos_e >= neg_e, one, -one)
    raise ValueError(f"unknown sign rule {rule!r}")


def project_polarize(mat: torch.Tensor, m: int, rule: str = "sum",
                     signs: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean projection of ``(K, N)`` onto the polarized set P.

    Returns ``(projected, signs)`` with ``signs`` of shape ``(F, N)``.
    If ``rule == 'frozen'`` the caller must pass ``signs``.
    """
    k = mat.shape[0]
    if rule == "frozen":
        if signs is None:
            raise ValueError("rule='frozen' requires signs")
    else:
        signs = fragment_signs(mat, m, rule)
    sign_grid = frag.expand_fragment_values(signs, m, k)
    projected = torch.where(mat * sign_grid >= 0, mat, torch.zeros_like(mat))
    return projected, signs
