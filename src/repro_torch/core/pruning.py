"""Crossbar-aware structured pruning (paper §III-A, §III-D.1).

Two structured-sparsity types on the 2-D crossbar view ``H`` of shape (K, N):
filter pruning removes whole columns (``alpha`` = fraction of columns kept),
filter-shape pruning whole rows (``beta`` = fraction of rows kept).  The
Euclidean projection onto that set keeps the columns/rows of largest L2 norm
and zeroes the rest.  Pruning saves crossbars only when the kept rows and
columns reach whole sub-arrays, so kept counts snap *up* to a multiple.

The functions take a matrix ``(K, N)`` or a stack of them ``(L, K, N)``
(one projection per layer), where the reference vmaps over the layers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Kept fractions for structured pruning of one layer."""

    alpha: float = 1.0  # fraction of columns (filters) kept
    beta: float = 1.0   # fraction of rows (filter-shapes) kept

    def __post_init__(self):
        if not (0.0 < self.alpha <= 1.0 and 0.0 < self.beta <= 1.0):
            raise ValueError(f"alpha/beta must be in (0, 1], got {self}")


def snap_kept_count(total: int, keep_fraction: float, multiple: int) -> int:
    """Kept count snapped UP to a multiple (never exceeds total, always >= 1)."""
    raw = max(1, int(round(total * keep_fraction)))
    snapped = -(-raw // multiple) * multiple
    return int(min(total, snapped))


def crossbar_aware_spec(shape: Tuple[int, int], spec: PruneSpec,
                        row_multiple: int, col_multiple: int) -> PruneSpec:
    """Adjust a PruneSpec so kept rows/cols land on crossbar boundaries."""
    k, n = shape
    kept_rows = snap_kept_count(k, spec.beta, min(row_multiple, k))
    kept_cols = snap_kept_count(n, spec.alpha, min(col_multiple, n))
    return PruneSpec(alpha=kept_cols / n, beta=kept_rows / k)


def _topk_mask(norms: torch.Tensor, kept: int) -> torch.Tensor:
    """Boolean mask keeping the ``kept`` largest entries of the last axis.

    Entries at or above the kept-th largest value are kept; when ties push
    the count above ``kept``, the first ``kept`` of them by index stay (the
    reference's tie-break).
    """
    n = norms.shape[-1]
    kept = int(min(max(kept, 1), n))
    if kept == n:
        return torch.ones(norms.shape, dtype=torch.bool, device=norms.device)
    thresh = torch.topk(norms, kept, dim=-1).values[..., -1:]
    mask = norms >= thresh
    overflow = torch.cumsum(mask.to(torch.int32), dim=-1) > kept
    return mask & ~overflow


def project_prune(mat: torch.Tensor, spec: PruneSpec
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euclidean projection of ``(K, N)`` onto the structured-sparse set S.

    Returns ``(projected, row_mask (K,), col_mask (N,))`` (with a leading L
    axis for a stack).
    """
    k, n = mat.shape[-2:]
    col_norms = torch.linalg.norm(mat, dim=-2)
    row_norms = torch.linalg.norm(mat, dim=-1)
    col_mask = _topk_mask(col_norms, int(round(spec.alpha * n)))
    row_mask = _topk_mask(row_norms, int(round(spec.beta * k)))
    projected = mat * col_mask[..., None, :] * row_mask[..., :, None]
    return projected, row_mask, col_mask


def apply_masks(mat: torch.Tensor, row_mask: torch.Tensor,
                col_mask: torch.Tensor) -> torch.Tensor:
    """Re-apply frozen pruning masks (used during fine-tuning after ADMM)."""
    return (mat * col_mask[..., None, :].to(mat.dtype)
            * row_mask[..., :, None].to(mat.dtype))


def sparsity(mat: torch.Tensor) -> torch.Tensor:
    """Fraction of exactly-zero entries."""
    return (mat == 0).float().mean()


def dense_shape_after_prune(shape: Tuple[int, int], spec: PruneSpec) -> Tuple[int, int]:
    """Shape of the dense matrix after removing pruned rows/columns."""
    k, n = shape
    return (max(1, int(round(spec.beta * k))), max(1, int(round(spec.alpha * n))))
