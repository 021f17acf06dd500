"""Plain PyTorch versions of the polarized matmul (the kernel's references).

``ref_polarized_matmul`` computes in the accelerator's fragment order
(per-fragment partial sums, then the signed combine); the sign-folded
``ref_polarized_matmul_fast`` is one f32 matmul against the folded weight.
Both are the same function; the CUDA kernel in ``polarized_matmul.py`` is
held against the fast form.
"""
from __future__ import annotations

import torch


def ref_polarized_matmul(x: torch.Tensor, mags: torch.Tensor,
                         signs: torch.Tensor, scale: torch.Tensor,
                         m: int) -> torch.Tensor:
    """y = x @ (sign_expanded * mags) * scale, in fragment order."""
    mk, n = mags.shape
    f = signs.shape[0]
    if f * m != mk:
        raise ValueError(f"signs {tuple(signs.shape)} do not cover mags "
                         f"{tuple(mags.shape)} in fragments of m={m}")
    xf = x.float().reshape(x.shape[0], f, m)
    wf = mags.float().reshape(f, m, n)
    partial = torch.einsum("bfm,fmn->bfn", xf, wf)
    y = torch.einsum("bfn,fn->bn", partial, signs.float())
    return y * scale


def ref_polarized_matmul_fast(x: torch.Tensor, mags: torch.Tensor,
                              signs: torch.Tensor, scale: torch.Tensor,
                              m: int) -> torch.Tensor:
    """Sign-folded form: one f32 matmul against ``repeat(signs) * mags``."""
    k = mags.shape[0]
    sign_grid = signs.float().repeat_interleave(m, dim=0)[:k]
    w = mags.float() * sign_grid
    return (x.float() @ w) * scale
