"""Plain PyTorch versions of the port's kernels (their references).

``ref_polarized_matmul`` computes in the accelerator's fragment order
(per-fragment partial sums, then the signed combine); the sign-folded
``ref_polarized_matmul_fast`` is one f32 matmul against the folded weight.
Both are the same function; the CUDA kernel in ``polarized_matmul.py`` is
held against the fast form.  ``ref_polarized_matmul_skip`` is its
zero-skipping variant at a tiling, ``ref_bitserial_crossbar`` the plain
version of the bit-serial simulator kernel and ``ref_exact_int_matmul`` the
integer product that simulator reaches with enough ADC bits.
``ref_admm_polarize`` is the plain version of the fragment-polarization
projection kernel of the ADMM Z-update.
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


def _tile_rows(mask: torch.Tensor, bm: int, M: int) -> torch.Tensor:
    """(M, 1) f32 row selector of one column of a tile mask."""
    return mask.float().repeat_interleave(bm)[:M, None]


def ref_polarized_matmul_skip(x: torch.Tensor, mags: torch.Tensor,
                              signs: torch.Tensor, scale: torch.Tensor,
                              mask, m: int, bm: int, bk: int) -> torch.Tensor:
    """The polarized matmul with input zero-skipping at a (bm, bk) tiling.

    ``mask`` is the int ``(ceil(M/bm), ceil(K/bk))`` tile occupancy of x
    (:func:`repro_torch.kernels.sparsity.block_mask`), or None for all
    tiles live.  The K tiles are summed in tile order and a dead tile adds
    nothing, so for a mask that describes x (dead tiles hold only zeros)
    the result equals the all-live one exactly: adding an exact 0 changes
    no sum.
    """
    M, K = x.shape
    n = mags.shape[1]
    if K % m or tuple(signs.shape) != (K // m, n):
        raise ValueError(f"signs {tuple(signs.shape)} do not cover mags "
                         f"{tuple(mags.shape)} in fragments of m={m}")
    w = mags.float() * signs.float().repeat_interleave(m, dim=0)
    xf = x.float()
    acc = torch.zeros((M, n), dtype=torch.float32, device=x.device)
    for t, k0 in enumerate(range(0, K, bk)):
        part = xf[:, k0:k0 + bk] @ w[k0:k0 + bk]
        if mask is not None:
            part = part * _tile_rows(mask[:, t], bm, M)
        acc = acc + part
    return acc * scale


def ref_bitserial_crossbar(x_codes: torch.Tensor, cell_planes: torch.Tensor,
                           signs: torch.Tensor, m: int, input_bits: int,
                           cell_bits: int, adc_bits=None, zero_skip: bool = True):
    """The FORMS crossbar's arithmetic, bit-serial; returns (acc, cycles).

    acc (M, N) int32: for every input bit b and cell plane c the
    per-fragment column sums of ``bit_b(x) * cell_c`` (clipped at the ADC
    ceiling ``2^adc_bits - 1``), signed by the fragment, shifted by
    ``c * cell_bits + b`` and summed, wrapping as int32 does.  cycles
    (scalar int32): the conversions consumed, a fragment stopping at its
    last live bit plane when ``zero_skip``.

    The per-plane dots run in f32, where they are exact (0/1 times a cell
    value, each sum at most ``K * (2^cell_bits - 1) < 2^24``; integer
    matmuls do not run on CUDA tensors); the shift-add runs in int64 and
    is wrapped to int32 at the end, the reference's two's-complement result.
    """
    mm, k = x_codes.shape
    c, k2, n = cell_planes.shape
    f = signs.shape[0]
    if k != k2 or f * m != k:
        raise ValueError(f"x {tuple(x_codes.shape)}, cells {tuple(cell_planes.shape)} "
                         f"and signs {tuple(signs.shape)} disagree for m={m}")
    x = x_codes.to(torch.int32).reshape(mm, f, m)
    sg = signs.float()
    acc = torch.zeros((mm, n), dtype=torch.int64, device=x.device)
    cycles = torch.zeros((), dtype=torch.int64, device=x.device)
    adc_max = None if adc_bits is None else (1 << adc_bits) - 1
    wc = [cell_planes[ci].float().reshape(f, m, n) for ci in range(c)]
    for b in range(input_bits):
        xb = ((x >> b) & 1).float().transpose(0, 1)            # (F, M, m)
        live = ((x >> b) != 0).any(dim=2)                       # (M, F)
        cycles = cycles + (live.sum() if zero_skip else mm * f)
        for ci in range(c):
            part = torch.bmm(xb, wc[ci])                        # (F, M, N)
            if adc_max is not None:
                part = part.clamp(max=float(adc_max))
            plane = (part * sg[:, None, :]).sum(dim=0)          # exact in f32
            acc = acc + (plane.to(torch.int64) << (ci * cell_bits + b))
    return _wrap_int32(acc), _wrap_int32(cycles)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32 as two's complement wraps it."""
    return (((v + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def ref_exact_int_matmul(x_codes: torch.Tensor, mag_codes: torch.Tensor,
                         signs: torch.Tensor, m: int) -> torch.Tensor:
    """``x_codes @ (repeat(signs, m) * mag_codes)`` as int32 (wrapping), the
    value the bit-serial simulator must reach with enough ADC bits.  Taken
    in float64, exact while every partial sum stays below 2^53 (checked)."""
    k = mag_codes.shape[0]
    w = mag_codes.double() * signs.double().repeat_interleave(m, dim=0)[:k]
    xd = x_codes.to(torch.int32).double()
    top = lambda t: float(t.abs().max()) if t.numel() else 0.0
    if top(xd) * top(w) * k >= 2.0 ** 53:
        raise ValueError("codes too large for an exact float64 product")
    return _wrap_int32((xd @ w).to(torch.int64))


# ---------------------------------------------------------------------------
# Fused polarization projection
# ---------------------------------------------------------------------------

def ref_admm_polarize(v: torch.Tensor, m: int, rule: str = "sum"):
    """Projection onto P: returns (projected, signs), both in v's dtype.

    ``v`` is ``(K, N)`` or a stack ``(L, K, N)`` with K a multiple of m;
    ``signs`` is ``(K/m, N)`` (or ``(L, K/m, N)``) of +-1.  Per (fragment,
    column) the sign is +1 iff the fragment's sum is >= 0 (``sum``) or its
    positive entries carry at least the squared mass of its negative ones
    (``energy``); entries whose product with the sign is negative become 0.
    The m rows of a fragment are added one after another in row order, in
    float32 (bf16 inputs are widened first), as the CUDA kernel adds them:
    a fragment summing to about 0 elects the same sign on both.  NaN
    compares false, so a NaN fragment elects -1 and its NaN is zeroed; a
    fragment summing to 0 or -0.0 elects +1; an entry of -0.0 is kept.
    """
    if rule not in ("sum", "energy"):
        raise ValueError(f"unknown sign rule {rule!r} (sum or energy)")
    k, n = v.shape[-2:]
    if m < 1 or k % m:
        raise ValueError(f"K={k} rows do not tile into fragments of m={m}; pad first")
    vf = v.float().reshape(*v.shape[:-2], k // m, m, n)
    if rule == "sum":
        acc = torch.zeros_like(vf[..., 0, :])
        for i in range(m):
            acc = acc + vf[..., i, :]
        up = acc >= 0
    else:
        pos_e = torch.zeros_like(vf[..., 0, :])
        neg_e = torch.zeros_like(pos_e)
        for i in range(m):
            p = torch.clamp(vf[..., i, :], min=0.0)   # NaN stays NaN
            q = torch.clamp(vf[..., i, :], max=0.0)
            pos_e = pos_e + p * p
            neg_e = neg_e + q * q
        up = pos_e >= neg_e
    s = torch.where(up, 1.0, -1.0)
    keep = vf * s[..., None, :] >= 0
    out = torch.where(keep, vf, torch.zeros((), dtype=vf.dtype, device=vf.device))
    return out.reshape(v.shape).to(v.dtype), s.to(v.dtype)
