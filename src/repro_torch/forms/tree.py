"""Whole-tree FORMS compression: ``compress_tree`` / ``decompress_tree``.

``compress_tree(params, spec)`` walks a parameter tree of nested dicts and
lists (xLSTM's per-layer ``blocks`` list; its paths read
``blocks/0/mlstm/wq``), in the reference's flatten order, and
replaces every crossbar-mappable weight with a
:class:`~repro_torch.forms.linear.FormsLinearParams` (uint8 magnitudes +
int8 fragment signs + f32 scales).  Scan-stacked ``(L, K, N)`` weights are
converted layer by layer (fragments never cross the layer axis), stacked
experts ``(L, E, K, N)`` (``EXPERT_WEIGHT_NAMES``) per (layer, expert), and
conv kernels are viewed through the polarization policy reshape.  Paths are the
JAX package's (``blocks/attn/wq``), so reports and plans line up one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Set, Tuple

import torch

from repro_torch.core.fragments import conv_to_matrix, is_crossbar_weight
from repro_torch.core.paths import children, is_node, map_in_order, path_str, tree_map
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


def _check_plan_covered(plan: Dict[str, FormsSpec], compressed: Set[str]) -> None:
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


# rank-4 leaves with these final path segments are scan-stacked expert
# tensors (L, E, in, out), one crossbar matrix per (layer, expert), not conv
# kernels (models/moe.py naming)
EXPERT_WEIGHT_NAMES = ("w_gate", "w_up", "w_down")


def _compress_leaf(pstr: str, leaf: torch.Tensor, spec: FormsSpec) -> FormsLinearParams:
    """Convert one 2-D / scan-stacked 3-D / conv or expert 4-D weight leaf."""
    name = pstr.rsplit("/", 1)[-1]
    if leaf.ndim == 3:
        fp = _stack([from_dense(w, spec)[0] for w in leaf])
    elif leaf.ndim == 4 and name in EXPERT_WEIGHT_NAMES:
        fp = _stack([_stack([from_dense(w, spec)[0] for w in experts])
                     for experts in leaf])
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
    *,
    load: Optional[Callable[[Tuple, Any], Any]] = None,
    store: Optional[Callable[[Tuple, Any], Any]] = None,
) -> Tuple[Any, CompressReport]:
    """Compress every crossbar-mappable weight of a params tree (nested
    dicts and lists).

    Returns ``(compressed, report)``: the same structure with weight leaves
    replaced by ``FormsLinearParams``; other leaves pass through untouched,
    and already-compressed leaves are left alone.  ``plan`` overrides the
    spec per leaf (:func:`spec_for_path`); an entry that matches no leaf
    raises.  ``load`` and ``store`` wrap each leaf in turn
    (:func:`~repro_torch.core.paths.map_in_order`): a mesh-placed tree is
    so gathered and cut back leaf by leaf.
    """
    report = CompressReport(errors={})
    compressed: Set[str] = set()

    def one(pstr, tree):
        if isinstance(tree, FormsLinearParams):
            compressed.add(pstr)
            report.bits[pstr] = tree.bits
            return tree
        if not isinstance(tree, torch.Tensor):
            return tree
        if not predicate(pstr, tuple(tree.shape)):
            report.num_skipped += 1
            return tree
        leaf_spec = spec_for_path(plan, pstr, spec)
        fp = _compress_leaf(pstr, tree, leaf_spec)
        recon = to_dense(fp)
        err = float(torch.linalg.norm((recon - tree).float())
                    / torch.clamp(torch.linalg.norm(tree.float()), min=1e-12))
        report.errors[pstr] = err
        report.bits[pstr] = leaf_spec.bits
        report.num_compressed += 1
        report.bytes_dense += tree.numel() * tree.element_size()
        report.bytes_compressed += sum(t.numel() * t.element_size()
                                       for t in (fp.mags, fp.signs, fp.scale))
        compressed.add(pstr)
        return fp

    # leaves in flatten order (dict keys sorted, lists by index), so the
    # report and the polarization launches go as the reference's
    out = map_in_order(one, params, load=load, store=store)
    if plan:
        _check_plan_covered(plan, compressed)
    return out, report


def decompress_tree(params: Any, validate: bool = True) -> Any:
    """Exact inverse of :func:`compress_tree`: every ``FormsLinearParams``
    leaf becomes its dense reconstruction (original shape and dtype).
    ``validate=True`` first checks the co-sharding invariants of any
    mesh-placed leaves (:func:`validate_tree_sharding`): reconstructing
    from a sign plane that shards differently from its magnitudes would
    apply wrong signs."""
    if validate:
        validate_tree_sharding(params)
    return tree_map(lambda leaf: to_dense(leaf) if isinstance(leaf, FormsLinearParams)
                    else leaf, params)


def compressed_paths(params: Any, prefix: Tuple = ()) -> Dict[str, FormsLinearParams]:
    """Map path -> FormsLinearParams for every compressed leaf."""
    if is_node(params):
        out: Dict[str, FormsLinearParams] = {}
        for k, v in children(params):
            out.update(compressed_paths(v, prefix + (k,)))
        return out
    if isinstance(params, FormsLinearParams):
        return {path_str(prefix): params}
    return {}


# ---------------------------------------------------------------------------
# Mesh sharding of compressed trees
# ---------------------------------------------------------------------------
# distributed.sharding is imported lazily: it imports forms.linear, which
# the package's __init__ imports before this module.

def shard_tree(params: Any, ctx: Any, fsdp: bool = False) -> Any:
    """This rank's pieces of a (possibly compressed) params tree on the mesh
    of ``ctx``: compressed leaves get the co-sharded (mags, signs, scale)
    trio, dense leaves the naming rules.  ``fsdp=False`` by default:
    serving wants tensor-parallel weights replicated over the data axes,
    not ZeRO-3 gathers in the decode loop."""
    from repro_torch.distributed.sharding import params_shardings, reshard_state
    return reshard_state(params, params_shardings(params, ctx, fsdp=fsdp))


def tree_sharding_specs(params: Any) -> Dict[str, Any]:
    """path -> ``mags`` spec of every mesh-placed compressed leaf."""
    return {pstr: tuple(fp.shard[0].spec) for pstr, fp in compressed_paths(params).items()
            if fp.shard is not None}


def _axis_shards(sizes: Dict[str, int], entry: Any) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def validate_tree_sharding(params: Any, mesh_shape: Optional[Dict[str, int]] = None
                           ) -> Dict[str, Any]:
    """Validate the co-sharding invariants of every mesh-placed compressed
    leaf: mags and signs shard their K/fragment axis identically and a K
    shard holds whole fragments (a multiple of ``m``); mags, signs and
    scale carry the same N entry; the scale's row axis is replicated.

    Raises ``ValueError`` naming the offending path; returns path -> mags
    spec of the leaves checked.  Leaves that are not mesh-placed are
    skipped.  The K shard count comes from ``mesh_shape`` (axis -> size)
    when given, else from the leaf's global and local shapes."""
    checked = {}
    for pstr, fp in compressed_paths(params).items():
        if fp.shard is None:
            continue
        mspec, sspec, cspec = (s.spec for s in fp.shard)
        if mspec[-1] != sspec[-1] or mspec[-1] != cspec[-1]:
            raise ValueError(
                f"{pstr}: N (output-column) axis must co-shard across "
                f"mags/signs/scale, got {mspec[-1]!r}/{sspec[-1]!r}/"
                f"{cspec[-1]!r} — per-column scales and fragment signs are "
                f"state of the same columns as the magnitudes")
        if mspec[-2] != sspec[-2]:
            raise ValueError(
                f"{pstr}: sign fragment axis must shard exactly like the "
                f"mags K axis (got {sspec[-2]!r} vs {mspec[-2]!r}); a "
                f"fragment's sign multiplies all {fp.m} of its rows")
        if cspec[-2] is not None:
            raise ValueError(
                f"{pstr}: scale row axis must be replicated, got "
                f"{cspec[-2]!r}")
        kp = fp.shard[0].shape[-2]
        if mspec[-2] is None:
            kshards = 1
        elif mesh_shape is not None:
            kshards = _axis_shards(mesh_shape, mspec[-2])
        else:
            kshards = max(1, kp // max(1, fp.mags.shape[-2]))
        if kshards > 1 and (kp % kshards != 0 or (kp // kshards) % fp.m != 0):
            raise ValueError(
                f"{pstr}: K={kp} sharded {kshards}-way gives "
                f"{kp / kshards:g}-row shards, not a multiple of the "
                f"fragment size m={fp.m} — sign blocks would straddle "
                f"devices.  Re-shard with shards*m dividing K.")
        checked[pstr] = tuple(mspec)
    return checked
