"""Whole-tree FORMS compression: ``compress_tree`` / ``decompress_tree``.

``compress_tree(params, spec)`` walks a nested-dict parameter tree and
replaces every crossbar-mappable weight with a
:class:`~repro_torch.forms.linear.FormsLinearParams` (uint8 magnitudes +
int8 fragment signs + f32 scales).  Scan-stacked ``(L, K, N)`` weights are
converted layer by layer (fragments never cross the layer axis); conv
kernels are viewed through the polarization policy reshape.  Paths are the
JAX package's (``blocks/attn/wq``), so reports and plans line up one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.fragments import conv_to_matrix, is_crossbar_weight
from repro_torch.core.paths import path_str
from repro_torch.forms.linear import FormsLinearParams, from_dense, to_dense
from repro_torch.forms.spec import FormsSpec


@dataclasses.dataclass
class CompressReport:
    """What ``compress_tree`` did: per-leaf errors and storage accounting."""

    errors: Dict[str, float]          # path -> relative L2 projection error
    num_compressed: int = 0
    num_skipped: int = 0              # tensor leaves left dense (non-crossbar)
    bytes_dense: int = 0              # bytes of the leaves that were compressed
    bytes_compressed: int = 0         # bytes of their FORMS representation
    bits: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.bytes_dense / max(self.bytes_compressed, 1)

    @property
    def max_error(self) -> float:
        return max(self.errors.values()) if self.errors else 0.0

    def bits_histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for b in self.bits.values():
            hist[b] = hist.get(b, 0) + 1
        return dict(sorted(hist.items()))

    def summary(self) -> str:
        hist = self.bits_histogram()
        bits_str = "/".join(f"{n}x{b}b" for b, n in hist.items()) or "-"
        return (f"{self.num_compressed} leaves compressed "
                f"({self.num_skipped} left dense, bits {bits_str}), "
                f"{self.bytes_dense / 1e6:.2f} MB -> "
                f"{self.bytes_compressed / 1e6:.2f} MB "
                f"({self.ratio:.2f}x), max rel-L2 err {self.max_error:.4f}")


def spec_for_path(plan: Optional[Dict[str, FormsSpec]], pstr: str,
                  default: Optional[FormsSpec] = None) -> FormsSpec:
    """Resolve the spec of the leaf at ``pstr`` under a per-leaf plan: exact
    path, then whole-segment suffix; an ambiguous suffix raises, and so does
    no match without a ``default``."""
    if plan:
        if pstr in plan:
            return plan[pstr]
        hits = [key for key in plan if pstr.endswith("/" + key)]
        if len(hits) > 1:
            raise ValueError(
                f"plan entries {sorted(hits)} all match leaf {pstr!r} — "
                f"disambiguate with fuller paths (e.g. the exact "
                f"'{pstr}')")
        if hits:
            return plan[hits[0]]
    if default is None:
        raise KeyError(
            f"no spec for leaf {pstr!r}: not covered by the plan "
            f"(keys: {sorted(plan or {})}) and no global default given")
    return default


def _check_plan_covered(plan: Dict[str, FormsSpec], compressed: Dict[str, Any]) -> None:
    unmatched = [key for key in plan
                 if key not in compressed
                 and not any(p.endswith("/" + key) for p in compressed)]
    if unmatched:
        raise ValueError(
            f"plan entries {sorted(unmatched)} matched no compressed leaf — "
            f"per-leaf overrides never fall back silently.  Compressed "
            f"leaves: {sorted(compressed)}")


def _stack(parts):
    first = parts[0]
    return dataclasses.replace(
        first, mags=torch.stack([p.mags for p in parts]),
        signs=torch.stack([p.signs for p in parts]),
        scale=torch.stack([p.scale for p in parts]))


def _compress_leaf(leaf: torch.Tensor, spec: FormsSpec) -> FormsLinearParams:
    """Convert one 2-D / scan-stacked 3-D / conv 4-D weight leaf."""
    if leaf.ndim == 3:
        fp = _stack([from_dense(w, spec)[0] for w in leaf])
    elif leaf.ndim == 4:
        fp, _ = from_dense(conv_to_matrix(leaf, spec.policy), spec)
        fp = dataclasses.replace(fp, orig_shape=tuple(leaf.shape))
    else:
        fp, _ = from_dense(leaf, spec)
    return dataclasses.replace(fp, out_dtype=str(leaf.dtype).removeprefix("torch."))


def compress_tree(
    params: Any,
    spec: Optional[FormsSpec] = FormsSpec(),
    predicate: Callable[[str, Tuple[int, ...]], bool] = is_crossbar_weight,
    plan: Optional[Dict[str, FormsSpec]] = None,
) -> Tuple[Any, CompressReport]:
    """Compress every crossbar-mappable weight of a nested-dict params tree.

    Returns ``(compressed, report)``: the same structure with weight leaves
    replaced by ``FormsLinearParams``; other leaves pass through untouched,
    and already-compressed leaves are left alone.  ``plan`` overrides the
    spec per leaf (:func:`spec_for_path`); an entry that matches no leaf
    raises.
    """
    report = CompressReport(errors={})
    compressed: Dict[str, Any] = {}

    def visit(tree, prefix):
        if isinstance(tree, dict):
            return {k: visit(tree[k], prefix + (k,)) for k in sorted(tree)}
        pstr = path_str(prefix)
        if isinstance(tree, FormsLinearParams):
            compressed[pstr] = tree
            report.bits[pstr] = tree.bits
            return tree
        if not isinstance(tree, torch.Tensor):
            return tree
        if not predicate(pstr, tuple(tree.shape)):
            report.num_skipped += 1
            return tree
        leaf_spec = spec_for_path(plan, pstr, spec)
        fp = _compress_leaf(tree, leaf_spec)
        recon = to_dense(fp)
        err = float(torch.linalg.norm((recon - tree).float())
                    / torch.clamp(torch.linalg.norm(tree.float()), min=1e-12))
        report.errors[pstr] = err
        report.bits[pstr] = leaf_spec.bits
        report.num_compressed += 1
        report.bytes_dense += tree.numel() * tree.element_size()
        report.bytes_compressed += sum(t.numel() * t.element_size()
                                       for t in (fp.mags, fp.signs, fp.scale))
        compressed[pstr] = fp
        return fp

    out = visit(params, ())
    if plan:
        _check_plan_covered(plan, compressed)
    return out, report


def decompress_tree(params: Any) -> Any:
    """Exact inverse of :func:`compress_tree`: every ``FormsLinearParams``
    leaf becomes its dense reconstruction (original shape and dtype)."""
    if isinstance(params, dict):
        return {k: decompress_tree(v) for k, v in params.items()}
    if isinstance(params, FormsLinearParams):
        return to_dense(params)
    return params


def compressed_paths(params: Any, prefix: Tuple = ()) -> Dict[str, FormsLinearParams]:
    """Map path -> FormsLinearParams for every compressed leaf."""
    if isinstance(params, dict):
        out: Dict[str, FormsLinearParams] = {}
        for k in sorted(params):
            out.update(compressed_paths(params[k], prefix + (k,)))
        return out
    if isinstance(params, FormsLinearParams):
        return {path_str(prefix): params}
    return {}
