"""Deterministic, seeded ReRAM fault injection on compressed FORMS trees.

One simulated *write -> array physics -> read* pass over the serving
artifact itself: the uint8 magnitude codes and int8 fragment signs of every
:class:`~repro_torch.forms.linear.FormsLinearParams` leaf.  It returns a
tree of the same structure, shapes, dtypes and devices whose codes are what
the corrupted array would serve.

Physical model, per cell (levels from ``reliability/encoding.py``):

* nominal conductance  ``g = g_min + level``  (units of one level step;
  ``g_min`` is the HRS floor);
* variation  ``g *= exp(sigma * (rho * z_col + sqrt(1-rho^2) * z_cell))``,
  a component ``z_col`` shared by every cell of a physical bitline plus an
  i.i.d. per-cell one;
* retention drift  ``g *= (1 + t)^(-nu_cell)``,
  ``nu_cell = nu * exp(nu_sigma * z)`` with the same split (at
  ``nu_sigma = 0`` drift is deterministic and fully column-common);
* stuck-at faults override the result with ``g_min + level_max`` (stuck
  SET) or ``g_min`` (stuck RESET), reference cells included.

Read-back follows the leaf's ``encoding``: ``binary`` reassembles the raw
levels, ``vecom`` first divides out the bitline gain estimated from the
reference cells.  With no noise both reproduce the stored codes exactly.

Everything runs on the host in numpy, with the JAX package's generator
(``np.random.default_rng([seed, crc32(path)])``) and its draw order, so
the port corrupts a leaf exactly as the reference does, code for code.
The reference materializes several float64 arrays the size of all cells of
a leaf; here the cells are walked in row chunks instead.  numpy's
``Generator`` fills in C order, and consecutive calls continue one stream,
so drawing a full-shape array chunk by chunk gives the same numbers, and
only the float64 conductances ``g`` of a leaf are kept whole.  Leaves are
injected in parallel threads (each has its own generator) under a host
memory budget.  The corrupted planes go back to each leaf's own device.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import threading
import zlib
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fragments import is_crossbar_weight
from repro_torch.core.paths import iter_leaves, map_with_path
from repro_torch.forms.linear import FormsLinearParams
from repro_torch.forms.spec import FormsSpec
from repro_torch.reliability import encoding as ENC

__all__ = ["FaultModel", "FaultReport", "LeafFaults", "inject_leaf",
           "inject_tree"]

#: cells per chunk of the walk: a few 32 MiB float64 temporaries per thread
CHUNK_CELLS = 1 << 22
_RING = 6      # random-number buffers in flight per leaf

#: the serving tree's dense head copy (``transformer.with_head_cast``): the
#: tied embedding's transpose, a lookup table and not a crossbar weight
SERVING_HEAD = "head_cast"


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One corrupted-array scenario (all knobs off by default = identity).

    sigma: lognormal conductance-variation scale (the source paper's Table
      VI uses 0.1 at the weight level).
    rho: column-common fraction of the variation/drift randomness in
      [0, 1], the part VECOM's reference columns can cancel.
    p_stuck_on / p_stuck_off: per-cell probability of sticking at G_on
      (level_max) / G_off.
    p_sign_stuck: per-fragment probability of the 1R sign indicator
      sticking SET (sign forced to +1).
    t: retention time since programming (units of the drift reference
      time); 0 = freshly programmed.
    nu: mean drift coefficient of ``(1 + t)^(-nu)``.
    nu_sigma: lognormal spread of per-cell drift coefficients (0 = fully
      deterministic drift).
    g_min: HRS conductance floor in level-step units (~1/on-off ratio).
    seed: base RNG seed; per-leaf streams fold in crc32(path).
    """

    sigma: float = 0.0
    rho: float = 0.6
    p_stuck_on: float = 0.0
    p_stuck_off: float = 0.0
    p_sign_stuck: float = 0.0
    t: float = 0.0
    nu: float = 0.02
    nu_sigma: float = 0.0
    g_min: float = 0.015
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [0, 1], got {self.rho}")
        for name in ("sigma", "p_stuck_on", "p_stuck_off", "p_sign_stuck",
                     "t", "nu", "nu_sigma", "g_min"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.p_stuck_on + self.p_stuck_off > 1.0:
            raise ValueError("p_stuck_on + p_stuck_off must be <= 1")

    @property
    def is_identity(self) -> bool:
        """True when injection provably changes nothing (the zero-noise
        round-trip invariant)."""
        return (self.sigma == 0.0 and self.t == 0.0
                and self.p_stuck_on == 0.0 and self.p_stuck_off == 0.0
                and self.p_sign_stuck == 0.0)


@dataclasses.dataclass
class LeafFaults:
    """Per-leaf injection accounting."""

    cells: int = 0             # magnitude cells simulated
    stuck_on: int = 0
    stuck_off: int = 0
    sign_flips: int = 0        # fragment signs changed by stuck indicators
    codes_changed: int = 0     # magnitude codes that read back differently
    mean_abs_dcode: float = 0.0
    max_abs_dcode: int = 0


@dataclasses.dataclass
class FaultReport:
    """What :func:`inject_tree` did, per leaf and in aggregate."""

    model: FaultModel
    leaves: Dict[str, LeafFaults] = dataclasses.field(default_factory=dict)

    @property
    def codes_changed(self) -> int:
        return sum(lf.codes_changed for lf in self.leaves.values())

    @property
    def stuck_cells(self) -> int:
        return sum(lf.stuck_on + lf.stuck_off for lf in self.leaves.values())

    @property
    def sign_flips(self) -> int:
        return sum(lf.sign_flips for lf in self.leaves.values())

    def summary(self) -> str:
        cells = sum(lf.cells for lf in self.leaves.values())
        return (f"{len(self.leaves)} leaves, {cells} cells: "
                f"{self.codes_changed} codes changed, "
                f"{self.stuck_cells} stuck cells, "
                f"{self.sign_flips} sign flips "
                f"(sigma={self.model.sigma:g}, rho={self.model.rho:g}, "
                f"t={self.model.t:g})")


def _leaf_rng(seed: int, pstr: str) -> np.random.Generator:
    # crc32, not hash(): per-process salting would break cross-run
    # determinism, which the repair tests rely on
    return np.random.default_rng([seed, zlib.crc32(pstr.encode())])


_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    """The threads that run the walk's chunk arithmetic (numpy releases
    the GIL in it); made at first use, never at import."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, os.cpu_count() or 1), thread_name_prefix="faults")
        return _POOL


class _Cells:
    """The cells of one leaf, their float64 conductances ``g`` of shape
    ``(C, B, Kp, N)`` (C planes, B = the leading stacked axes flattened),
    and the row chunks the walk visits them in.  ``g`` is kept whole only
    where a noise pass must visit it plane by plane (or the leaf is one
    chunk); otherwise each read-back chunk programs its own cells."""

    def __init__(self, planes: int, mags: np.ndarray, spec: FormsSpec, g_min: float,
                 keep: bool):
        kp, n = mags.shape[-2:]
        self.planes, self.kp, self.n = planes, kp, n
        self.blocks = mags.reshape(-1, kp, n)
        self.nb = self.blocks.shape[0]
        self.col_shape = (planes,) + mags.shape[:-2] + (1, n)
        self.size = planes * mags.size
        self.cell_bits, self.lmax, self.g_min = spec.cell_bits, ENC.max_level(spec), g_min
        # a leaf of at most one chunk is read back in one piece, as the
        # reference reads it; larger ones in chunks of >= 4 columns, where
        # tensordot's per-element sum does not depend on the chunk
        self.whole = self.size <= CHUNK_CELLS
        self.rows = max(4, CHUNK_CELLS // (planes * n))
        self.g = (np.empty((planes, self.nb, kp, n), np.float64)
                  if keep or self.whole else None)
        if self.g is not None:
            self.each(lambda c, b, r: self.program(c, b, r, self.g[c, b, r]),
                      self.plane_chunks())

    def program(self, c: int, b: int, r: slice, out: np.ndarray) -> None:
        """``g = g_min + level`` of plane ``c`` of a row chunk: the level
        stays an integer until the add, as in the reference's float64 sum."""
        np.add((self.blocks[b, r] >> (c * self.cell_bits)) & self.lmax, self.g_min, out=out)

    def conductances(self, b: int, r: slice) -> np.ndarray:
        """The ``(C, rows, N)`` conductances of a row chunk, every plane."""
        if self.g is not None:
            return self.g[:, b, r]
        g = np.empty((self.planes,) + self.chunk_shape(r))
        for c in range(self.planes):
            self.program(c, b, r, g[c])
        return g

    def row_chunks(self) -> Iterator[Tuple[int, slice]]:
        for b in range(self.nb):
            for r0 in range(0, self.kp, self.rows):
                yield b, slice(r0, min(r0 + self.rows, self.kp))

    def plane_chunks(self) -> Iterator[Tuple[int, int, slice]]:
        """Every cell once, in C order of ``(C, ..., Kp, N)``: the order the
        reference's full-shape draws fill."""
        for c in range(self.planes):
            for b, r in self.row_chunks():
                yield c, b, r

    def chunk_shape(self, r: slice) -> Tuple[int, int]:
        return (r.stop - r.start, self.n)

    def each(self, fn: Callable[..., Any], chunks) -> List[Any]:
        """``fn(*chunk)`` for every chunk, on the pool; results in order."""
        return [f.result() for f in [_pool().submit(fn, *ch) for ch in chunks]]

    def drawn(self, draw: Callable[[np.ndarray], Any],
              fn: Callable[[int, int, np.ndarray, np.ndarray], Any]) -> List[Any]:
        """For every cell chunk, in C order: ``draw(buf)`` fills a buffer of
        the chunk's shape with random numbers on this thread (the
        generator's stream is sequential), and ``fn(c, b, g_chunk, buf)``
        runs on the pool, in place on the buffer.  A ring of buffers keeps
        a few chunks in flight."""
        ring = [np.empty((min(self.rows, self.kp), self.n)) for _ in range(_RING)]
        live: "collections.deque[concurrent.futures.Future]" = collections.deque()
        out = []
        for i, (c, b, r) in enumerate(self.plane_chunks()):
            if len(live) == _RING:      # the buffer about to be reused is free
                out.append(live.popleft().result())
            buf = ring[i % _RING][:r.stop - r.start]
            draw(buf)
            live.append(_pool().submit(fn, c, b, self.g[c, b, r], buf))
        return out + [f.result() for f in live]


def _noise_pass(rng: np.random.Generator, rho: float, cells: _Cells,
                apply: Callable[[np.ndarray, np.ndarray], None]) -> np.ndarray:
    """The reference's column-common + i.i.d. standard-normal split, one
    chunk at a time: ``z_col`` (one per physical bitline), the weight
    cells' draws (``apply(g_chunk, z_chunk)`` gets the combined normal),
    then the reference cells' draws, returned as ``(N_REF,) + col_shape``."""
    z_col = rng.standard_normal(cells.col_shape)
    mix = np.sqrt(max(0.0, 1.0 - rho * rho))
    zc = (rho * z_col).reshape(cells.planes, cells.nb, 1, cells.n)

    def combine(c, b, g, z):
        # rho * z_col + mix * draw, in place on the draws
        np.multiply(mix, z, out=z)
        np.add(zc[c, b], z, out=z)
        apply(g, z)

    cells.drawn(lambda buf: rng.standard_normal(out=buf), combine)
    return rho * z_col + mix * rng.standard_normal((ENC.N_REF,) + cells.col_shape)


def inject_leaf(fp: FormsLinearParams, fault: FaultModel, pstr: str,
                spec: Optional[FormsSpec] = None
                ) -> Tuple[FormsLinearParams, LeafFaults]:
    """Simulate one write/corrupt/read pass over a compressed leaf.

    Operates in the leaf's native domain (its magnitude codes and int8
    fragment signs) and returns a leaf of identical structure, shapes,
    dtypes and device whose codes are the corrupted read-back.  ``spec``
    supplies the cell geometry (``cell_bits``); the readout discipline is
    ``fp.encoding``, and the leaf's own ``m``/``bits`` override the
    caller's, so a mixed-precision tree injects into each leaf's own cell
    count.
    """
    spec = dataclasses.replace(spec, m=fp.m, bits=fp.bits) \
        if spec is not None else FormsSpec(m=fp.m, bits=fp.bits)
    rng = _leaf_rng(fault.seed, pstr)
    mags = fp.mags.detach().cpu().numpy()
    signs = fp.signs.detach().cpu().numpy()
    stats = LeafFaults()
    lmax = float(ENC.max_level(spec))
    noisy = (fault.sigma > 0.0 or (fault.t > 0.0 and fault.nu > 0.0)
             or fault.p_stuck_on > 0.0 or fault.p_stuck_off > 0.0)
    cells = _Cells(ENC.num_planes(spec), mags, spec, fault.g_min, keep=noisy)
    stats.cells = cells.size
    g_ref = np.full((ENC.N_REF,) + cells.col_shape, fault.g_min + lmax)
    if fault.sigma > 0.0:
        def vary(g, z):
            np.multiply(fault.sigma, z, out=z)
            np.multiply(g, np.exp(z, out=z), out=g)
        z_refs = _noise_pass(rng, fault.rho, cells, vary)
        g_ref = g_ref * np.exp(fault.sigma * z_refs)
    if fault.t > 0.0 and fault.nu > 0.0:
        nu_r = fault.nu
        if fault.nu_sigma > 0.0:
            def drift(g, z):
                # g * (1 + t) ** -(nu * exp(nu_sigma * z)), in place on z
                np.multiply(fault.nu_sigma, z, out=z)
                np.multiply(fault.nu, np.exp(z, out=z), out=z)
                np.power(1.0 + fault.t, np.negative(z, out=z), out=z)
                np.multiply(g, z, out=g)
            z_refs = _noise_pass(rng, fault.rho, cells, drift)
            nu_r = fault.nu * np.exp(fault.nu_sigma * z_refs)
        else:
            def decay(c, b, r):
                g = cells.g[c, b, r]
                np.multiply(g, (1.0 + fault.t) ** -fault.nu, out=g)
            cells.each(decay, cells.plane_chunks())
        g_ref = g_ref * (1.0 + fault.t) ** -nu_r
    if fault.p_stuck_on > 0.0 or fault.p_stuck_off > 0.0:
        def stick(c, b, g, u):
            on = u < fault.p_stuck_on
            off = (~on) & (u < fault.p_stuck_on + fault.p_stuck_off)
            np.copyto(g, fault.g_min, where=off)
            np.copyto(g, fault.g_min + lmax, where=on)
            return int(np.count_nonzero(on)), int(np.count_nonzero(off))
        # Generator.random draws the doubles uniform(0, 1) draws, into a buffer
        counts = cells.drawn(lambda buf: rng.random(out=buf), stick)
        stats.stuck_on = sum(n for n, _ in counts)
        stats.stuck_off = sum(n for _, n in counts)
        # reference cells are cells too: a stuck reference breaks its
        # column's compensation, which is the health monitor's problem
        u_ref = rng.uniform(size=g_ref.shape)
        g_ref = np.where(u_ref < fault.p_stuck_on, fault.g_min + lmax, g_ref)
        g_ref = np.where(
            (u_ref >= fault.p_stuck_on)
            & (u_ref < fault.p_stuck_on + fault.p_stuck_off),
            fault.g_min, g_ref)

    gain = None
    if fp.encoding == "vecom":
        gain = ENC.column_gain(g_ref, fault.g_min + lmax)
    new_mags = np.empty_like(mags)
    wide = np.int16 if spec.bits <= 8 else np.int64

    def read_back(g, gain_part, old, out):
        # g / gain - g_min (binary: g - g_min), clipped: in place on g
        if gain_part is not None:
            np.divide(g, gain_part, out=g)
        np.subtract(g, fault.g_min, out=g)
        out[...] = ENC.radix_read(np.clip(g, 0.0, lmax, out=g), spec)
        dcode = np.abs(out.astype(wide) - old.astype(wide))
        return (int(dcode.sum(dtype=np.int64)), int(np.count_nonzero(dcode)),
                int(dcode.max()) if dcode.size else 0)

    if cells.whole:
        parts = [read_back(cells.g.reshape((cells.planes,) + mags.shape), gain, mags,
                           new_mags)]
    else:
        gain_b = (gain.reshape(cells.planes, cells.nb, 1, cells.n)
                  if gain is not None else None)
        out_blocks = new_mags.reshape(cells.blocks.shape)
        parts = cells.each(
            lambda b, r: read_back(cells.conductances(b, r),
                                   gain_b[:, b] if gain_b is not None else None,
                                   cells.blocks[b, r], out_blocks[b, r]),
            cells.row_chunks())
    del cells

    new_signs = signs
    if fault.p_sign_stuck > 0.0:
        stuck = rng.uniform(size=signs.shape) < fault.p_sign_stuck
        new_signs = np.where(stuck, np.int8(1), signs)
        stats.sign_flips = int((new_signs != signs).sum())

    size = mags.size
    stats.codes_changed = sum(p[1] for p in parts)
    # the integer sum is exact, as numpy's float64 mean of these integers is
    stats.mean_abs_dcode = float(sum(p[0] for p in parts)) / size if size else 0.0
    stats.max_abs_dcode = max(p[2] for p in parts)
    out = dataclasses.replace(
        fp, mags=_put_like(new_mags.astype(mags.dtype), fp.mags),
        signs=_put_like(np.asarray(new_signs).astype(signs.dtype), fp.signs))
    return out, stats


def _put_like(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array back on its predecessor's device, in its dtype."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device, like.dtype)


def host_budget_bytes() -> int:
    """Half the host memory free now: what the leaves injected at once may
    hold (a leaf larger than that runs alone)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2
    except (ValueError, OSError, AttributeError):
        return 8 << 30


def _leaf_cost(fp: FormsLinearParams, spec: Optional[FormsSpec]) -> int:
    """Host bytes of a leaf's walk: its float64 cells and a few copies of
    its codes."""
    cell_bits = spec.cell_bits if spec is not None else FormsSpec().cell_bits
    return fp.mags.numel() * (8 * (fp.bits // cell_bits) + 4 * fp.mags.element_size())


def _run_bounded(jobs: List[Tuple[int, Callable[[], Any]]], budget: int) -> List[Any]:
    """Run ``jobs`` (cost, fn) on threads, in order, with at most the CPU
    count in flight and their summed cost within ``budget``; a job dearer
    than the budget runs alone.  Results come back in job order."""
    cond = threading.Condition()
    live = {"cost": 0, "n": 0}
    workers = max(1, os.cpu_count() or 1)

    def run(cost, fn):
        try:
            return fn()
        finally:
            with cond:
                live["cost"] -= cost
                live["n"] -= 1
                cond.notify_all()

    futures = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        for cost, fn in jobs:
            with cond:
                cond.wait_for(lambda: live["n"] == 0 or (
                    live["n"] < workers and live["cost"] + cost <= budget))
                live["cost"] += cost
                live["n"] += 1
            futures.append(pool.submit(run, cost, fn))
        return [f.result() for f in futures]


def replace_leaves(tree: Any, new: Dict[str, Any], prefix: Tuple = ()) -> Any:
    """``tree`` with the leaves at the paths of ``new`` replaced; every
    other leaf is passed through by reference."""
    return map_with_path(lambda p, leaf: new.get(p, leaf), tree, prefix)


def inject_tree(
    params: Any,
    fault: FaultModel,
    spec: Optional[FormsSpec] = None,
    paths: Optional[Iterable[str]] = None,
    predicate: Callable[[str, Tuple[int, ...]], bool] = is_crossbar_weight,
    allow_dense: bool = False,
) -> Tuple[Any, FaultReport]:
    """Corrupt every compressed leaf of a params tree; returns
    ``(corrupted, report)``.

    ``paths`` (optional) restricts injection to the named leaves; every
    other leaf passes through untouched, by reference.  A crossbar-mappable
    leaf that is still dense (``predicate`` matches a plain tensor) means
    the tree was never compressed, and silently skipping it would report a
    resilience the deployment does not have: that raises unless
    ``allow_dense=True``.
    """
    wanted = set(paths) if paths is not None else None
    report = FaultReport(model=fault)
    todo: List[Tuple[str, FormsLinearParams]] = []
    for pstr, leaf in iter_leaves(params):
        if isinstance(leaf, FormsLinearParams):
            if wanted is None or pstr in wanted:
                todo.append((pstr, leaf))
            continue
        if (not allow_dense and isinstance(leaf, torch.Tensor) and pstr != SERVING_HEAD
                and predicate(pstr, tuple(leaf.shape))):
            raise ValueError(
                f"fault injection on a tree with a DENSE crossbar leaf "
                f"{pstr!r} (shape {tuple(leaf.shape)}): ReRAM faults only "
                f"exist for compressed leaves — run "
                f"repro_torch.forms.compress_tree first (serve with forms=True / "
                f"--forms), or pass allow_dense=True to knowingly leave "
                f"dense leaves un-faulted")
    if wanted is not None and wanted - {p for p, _ in todo}:
        raise ValueError(
            f"paths not found as compressed leaves: "
            f"{sorted(wanted - {p for p, _ in todo})}"
            f" — see repro_torch.forms.compressed_paths() for the valid names")
    results = _run_bounded(
        [(_leaf_cost(leaf, spec),
          lambda leaf=leaf, pstr=pstr: inject_leaf(leaf, fault, pstr, spec=spec))
         for pstr, leaf in todo], host_budget_bytes())
    new = {}
    for (pstr, _), (new_leaf, stats) in zip(todo, results):
        report.leaves[pstr] = stats
        new[pstr] = new_leaf
    return replace_leaves(params, new), report
