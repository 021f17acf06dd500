"""Auto mixed-precision compression search, in PyTorch.

The port of the JAX package's ``forms/autobits.py``: per-leaf magnitude
widths chosen from a Fisher-diagonal sensitivity sweep, priced by the FORMS
crossbar's ADC conversion events.

1. **Sensitivity pass** — the Fisher diagonal (mean squared NLL gradient,
   ``torch.autograd`` over the dense tree, one forward and backward per
   calibration batch) times the exact displacement of every crossbar leaf
   at every candidate width, through ``compress_tree`` and the leaf's
   dense reconstruction::

       dL(leaf, b)  ~=  1/2 * sum  F  .  (Q_b(W) - W)^2

   summed per column, and per ``n_sub_cols``-wide column group for the
   report.  Leaves are keyed by the reference's path strings and visited in
   its flatten order (sorted dict keys), and the dense, Fisher and projected
   leaves are matched by path.
2. **Allocator** — a greedy bits-down knapsack over the candidate ladder,
   priced by ``core/perfmodel.ThroughputSpec`` conversion-event arithmetic:
   maximise modeled throughput under a predicted-loss budget
   (``serve --auto-bits --acc-budget``), or minimise predicted loss at a
   modeled cost (:func:`plan_draft_bits`, the speculative draft).  The
   modeled seconds are the paper's ReRAM accelerator model, never GPU time:
   a mixed plan stores uint8 codes at every width, so its bytes on the card
   equal the uniform 8-bit tree's.  The modeled FLOPs are set beside the
   FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts over one dense
   forward (matmuls and attention products; elementwise work is not
   counted, so the share differs from the reference's XLA figure).
3. **Plan artifact** — :class:`AutoBitsPlan`; ``plan.specs()`` is the
   ``{path: FormsSpec}`` map ``compress_tree(plan=...)`` takes, and
   :func:`plan_to_meta` / :func:`plan_from_meta` carry it through a
   checkpoint's ``extra_meta`` in the reference's layout.

On the card a FORMS leaf is not rebuilt inside a forward
(``models/layers.wload``), so the sensitivity pass decompresses a
compressed tree first, as the reference does; the validation forwards run
the compressed trees through the polarized-matmul kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import perfmodel as pm
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.paths import iter_leaves, rebuild
from repro_torch.forms.linear import FormsLinearParams, to_dense
from repro_torch.forms.spec import FormsSpec, spec_from_meta
from repro_torch.forms.tree import compress_tree, compressed_paths, decompress_tree

# ---------------------------------------------------------------------------
# configuration / artifacts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoBitsConfig:
    """Knobs of one auto-bits search.

    acc_budget: max predicted loss increase (mean-NLL nats) of the plan
      over the uniform base-bits tree — the knapsack constraint.
    candidate_bits: the bit-width ladder (cell-aligned; each candidate is
      validated through ``FormsSpec.with_bits``).
    min_bits: floor a leaf can be driven down to.
    calib_batches/calib_batch/calib_len/seed: the calibration stream's shape
      when no batches are given (seeded random tokens).
    """

    acc_budget: float = 0.05
    candidate_bits: Tuple[int, ...] = (8, 6, 4, 2)
    min_bits: int = 2
    calib_batches: int = 2
    calib_batch: int = 8
    calib_len: int = 32
    seed: int = 0


@dataclasses.dataclass
class LeafSensitivity:
    """Sensitivity and geometry of one crossbar leaf."""

    path: str
    stack: int                      # leading layer multiplicity
    kp: int                         # padded input rows
    n: int                          # output columns
    m: int                          # fragment size
    dl: Dict[int, float]            # bits -> predicted loss delta (absolute)
    group_dl: Dict[int, np.ndarray]  # bits -> per sub-array column group dl

    def dl_rel(self, bits: int, base: int) -> float:
        """Predicted loss increase of ``bits`` over the ``base`` width."""
        return max(0.0, self.dl[bits] - self.dl[base])


@dataclasses.dataclass
class SensitivityTable:
    """Per-leaf sensitivities and the shared cost model of one sweep."""

    leaves: Dict[str, LeafSensitivity]
    spec: FormsSpec                 # the base spec of the sweep
    calib_tokens: int = 0           # tokens seen by the Fisher pass
    fwd_flops: Optional[float] = None   # FlopCounterMode FLOPs of one fwd batch
    modeled_flops: Optional[float] = None  # 2*MACs of the priced leaves

    def leaf_seconds(self, path: str, bits: int) -> float:
        ls = self.leaves[path]
        return modeled_leaf_seconds(ls.stack, ls.kp, ls.n, ls.m, bits, self.spec)

    def plan_seconds(self, bits: Dict[str, int]) -> float:
        return sum(self.leaf_seconds(p, b) for p, b in bits.items())

    def plan_dl(self, bits: Dict[str, int]) -> float:
        base = self.spec.bits
        return sum(ls.dl_rel(bits[p], base) for p, ls in self.leaves.items())


@dataclasses.dataclass
class AutoBitsPlan:
    """The chosen per-leaf widths with their prediction and report."""

    spec: FormsSpec                 # base spec (non-bits fields shared)
    bits: Dict[str, int]            # path -> magnitude bits
    predicted_dl: float             # predicted mean-NLL increase vs base
    acc_budget: float               # the budget it was solved under
    modeled_seconds: float          # modeled ADC time of the plan
    base_seconds: float             # modeled ADC time of uniform base bits
    matched_uniform: Optional[int] = None   # cost-matched solve target
    measured_dl: Optional[float] = None     # calibration NLL delta (validated)
    table: Optional[SensitivityTable] = None

    @property
    def modeled_speedup(self) -> float:
        """The ReRAM ADC-event model's throughput gain over the uniform
        base-bits tree (not a time on the GPU)."""
        return self.base_seconds / max(self.modeled_seconds, 1e-30)

    def specs(self) -> Dict[str, FormsSpec]:
        """The ``{path: FormsSpec}`` plan ``compress_tree(plan=...)`` takes."""
        return {p: self.spec.with_bits(b) for p, b in self.bits.items()}

    def histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for b in self.bits.values():
            hist[b] = hist.get(b, 0) + 1
        return dict(sorted(hist.items()))

    def top_groups(self, k: int = 3) -> List[Tuple[str, int, float]]:
        """The most loss-sensitive (leaf, column-group) pairs at the chosen
        widths — the crossbar sub-arrays that pinned their leaves high."""
        if self.table is None:
            return []
        out = []
        for p, b in self.bits.items():
            gd = self.table.leaves[p].group_dl.get(b)
            if gd is None or not len(gd):
                continue
            g = int(np.argmax(gd))
            out.append((p, g, float(gd[g])))
        out.sort(key=lambda t: -t[2])
        return out[:k]

    def summary(self) -> str:
        hist = "/".join(f"{n}x{b}b" for b, n in self.histogram().items())
        parts = [f"{len(self.bits)} leaves [{hist}]",
                 f"modeled speedup {self.modeled_speedup:.2f}x vs uniform "
                 f"{self.spec.bits}b (ReRAM ADC-event model, not GPU time)",
                 f"predicted dNLL {self.predicted_dl:.4f} "
                 f"(budget {self.acc_budget:g})"]
        if self.measured_dl is not None:
            parts.append(f"measured dNLL {self.measured_dl:+.4f}")
        if self.matched_uniform is not None:
            parts.append(f"cost-matched to uniform {self.matched_uniform}b")
        if self.table is not None and self.table.fwd_flops:
            parts.append(f"cost model covers {flop_coverage(self.table):.0%} of counted "
                         f"fwd FLOPs")
        return ", ".join(parts)


def flop_coverage(table: SensitivityTable) -> float:
    """The priced leaves' share of one forward's counted FLOPs."""
    return (table.modeled_flops or 0.0) / table.fwd_flops


# ---------------------------------------------------------------------------
# cost model (ThroughputSpec conversion-event arithmetic)
# ---------------------------------------------------------------------------

#: FORMS periphery constants of ``perfmodel.forms_throughput`` at the paper's
#: iso-area design point — 4 ADCs per crossbar at 2.1 GHz (paper §IV-C).
_ADCS_PER_CROSSBAR = 4
_ADC_FREQ_GHZ = 2.1


def modeled_leaf_seconds(stack: int, kp: int, n: int, m: int, bits: int,
                         spec: FormsSpec) -> float:
    """Modeled ADC-limited seconds to produce one input vector's outputs.

    A leaf's column needs ``Kp / m`` fragment waves, each converted once per
    input bit, and a ``bits``-bit magnitude occupies ``bits / cell_bits``
    cell columns, so conversion events scale with the stored cells (paper
    §III-C cell slicing, §IV-C event arithmetic).
    """
    t = pm.ThroughputSpec(rows=max(kp, 1), fragment=m,
                          adcs_per_crossbar=_ADCS_PER_CROSSBAR,
                          adc_freq_ghz=_ADC_FREQ_GHZ, input_bits=spec.input_bits)
    cells = max(1, bits // spec.cell_bits)
    events = stack * n * cells * t.events_per_column_per_input
    return events / (t.event_rate_gs * 1e9)


def uniform_seconds(table: SensitivityTable, bits: int) -> float:
    return sum(table.leaf_seconds(p, bits) for p in table.leaves)


# ---------------------------------------------------------------------------
# sensitivity pass
# ---------------------------------------------------------------------------


def _has_forms_leaves(params: Any) -> bool:
    return any(isinstance(leaf, FormsLinearParams) for _, leaf in iter_leaves(params))


def random_calibration(vocab_size: int, cfg: AutoBitsConfig,
                       device: Union[str, torch.device, None] = DEFAULT_DEVICE
                       ) -> List[torch.Tensor]:
    """Seeded random int32 token batches (the reference's
    ``RandomState(seed).randint`` draws) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    return [torch.from_numpy(rng.randint(0, vocab_size, size=(cfg.calib_batch, cfg.calib_len))
                             .astype(np.int32)).to(dev)
            for _ in range(cfg.calib_batches)]


def _nll(model: Any, params: Any, toks: torch.Tensor) -> torch.Tensor:
    lg, _ = model.forward(params, {"tokens": toks})
    ll = torch.log_softmax(lg[:, :-1].float(), dim=-1)
    return -ll.gather(-1, toks[:, 1:, None].long()).mean()


def fisher_diag(model: Any, params: Any, batches: Sequence[torch.Tensor]) -> Any:
    """Mean squared NLL gradient per parameter (the empirical Fisher
    diagonal) of a dense tree, one forward and backward per batch.  Each
    batch's gradients are added into the accumulator and dropped."""
    flat = dict(iter_leaves(params))
    leaves = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
    tree = rebuild(params, leaves)
    fisher = {p: torch.zeros_like(t) for p, t in flat.items()}
    order = list(leaves)
    for toks in batches:
        with torch.enable_grad():
            loss = _nll(model, tree, toks)
            grads = torch.autograd.grad(loss, [leaves[p] for p in order], allow_unused=True)
        for p, g in zip(order, grads):
            if g is not None:
                fisher[p].addcmul_(g, g)
        del loss, grads
    n = max(1, len(batches))
    for f in fisher.values():
        f.div_(n)
    return rebuild(params, fisher)


def measured_nll(model: Any, params: Any, batches: Sequence[torch.Tensor]) -> float:
    """Mean calibration NLL of a dense or compressed tree."""
    with torch.inference_mode():
        vals = [_nll(model, params, t).cpu().numpy() for t in batches]
    return float(np.mean(vals))


def _forward_flops(model: Any, params: Any, batch: torch.Tensor) -> float:
    """FLOPs of one dense forward as ``FlopCounterMode`` counts them."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.forward(params, {"tokens": batch})
    return float(counter.get_total_flops())


def measure_sensitivity(model: Any, params: Any, spec: FormsSpec = FormsSpec(),
                        cfg: AutoBitsConfig = AutoBitsConfig(),
                        calib: Optional[Sequence[torch.Tensor]] = None) -> SensitivityTable:
    """The whole sweep: the Fisher pass, then per candidate width one
    ``compress_tree`` and each leaf's displacement, reduced per column.
    A compressed tree is decompressed first, so the sweep prices what the
    target serves."""
    if _has_forms_leaves(params):
        params = decompress_tree(params)
    if calib is None:
        calib = random_calibration(model.config.vocab_size, cfg, model.device)
    fisher = dict(iter_leaves(fisher_diag(model, params, calib)))

    candidates = sorted({int(b) for b in cfg.candidate_bits} | {spec.bits}, reverse=True)
    for b in candidates:
        spec.with_bits(b)       # fail fast on off-ladder candidates

    dense = list(iter_leaves(params))
    leaves: Dict[str, LeafSensitivity] = {}
    with torch.no_grad():
        for b in candidates:
            comp, _ = compress_tree(params, spec.with_bits(b))
            geom = compressed_paths(comp)
            for pstr, w in dense:
                fp = geom.get(pstr)
                if fp is None:
                    continue
                d = to_dense(fp) - w
                f = fisher[pstr]
                # per-column quadratic loss: 1/2 sum_rows F * (Q_b(W) - W)^2
                cols = (0.5 * (f * d * d).reshape(-1, d.shape[-1]).float().sum(dim=0)
                        ).cpu().numpy()
                del d
                edges = np.arange(0, cols.shape[0], spec.n_sub_cols)
                groups = np.add.reduceat(cols, edges) if cols.size else cols
                ls = leaves.get(pstr)
                if ls is None:
                    stack = int(np.prod(fp.mags.shape[:-2], dtype=np.int64))
                    ls = leaves[pstr] = LeafSensitivity(
                        path=pstr, stack=max(1, stack), kp=int(fp.mags.shape[-2]),
                        n=int(fp.mags.shape[-1]), m=fp.m, dl={}, group_dl={})
                ls.dl[b] = float(cols.sum())
                ls.group_dl[b] = groups
            del comp, geom
    del fisher
    modeled = sum(2.0 * ls.stack * ls.kp * ls.n for ls in leaves.values())
    tokens_per_batch = int(calib[0].shape[0] * calib[0].shape[1])
    return SensitivityTable(
        leaves=leaves, spec=spec,
        calib_tokens=sum(int(t.shape[0] * t.shape[1]) for t in calib),
        fwd_flops=_forward_flops(model, params, calib[0]),
        modeled_flops=modeled * tokens_per_batch)


# ---------------------------------------------------------------------------
# allocator (greedy bits-down knapsack)
# ---------------------------------------------------------------------------


def _ladder(table: SensitivityTable, cfg: AutoBitsConfig) -> List[int]:
    base = table.spec.bits
    steps = sorted({b for b in cfg.candidate_bits if cfg.min_bits <= b <= base},
                   reverse=True)
    if not steps or steps[0] != base:
        steps = [base] + steps
    return steps


def solve_bits(table: SensitivityTable, cfg: AutoBitsConfig = AutoBitsConfig(),
               acc_budget: Optional[float] = None,
               seconds_target: Optional[float] = None) -> Dict[str, int]:
    """Greedy bits-down: take the (leaf, step-down) with the most modeled
    seconds saved per unit of predicted loss, the first such leaf in the
    table's order on a tie, until the cumulative predicted loss would pass
    ``acc_budget`` (throughput-max) or the modeled seconds reach
    ``seconds_target`` (loss-min, the draft derivation)."""
    if (acc_budget is None) == (seconds_target is None):
        raise ValueError("pass exactly one of acc_budget / seconds_target")
    base = table.spec.bits
    ladder = _ladder(table, cfg)
    bits = {p: base for p in table.leaves}
    total_dl = 0.0
    eps = 1e-12
    while True:
        if seconds_target is not None and table.plan_seconds(bits) <= seconds_target:
            break
        best, best_score = None, -1.0
        for p, ls in table.leaves.items():
            i = ladder.index(bits[p])
            if i + 1 >= len(ladder):
                continue
            nb = ladder[i + 1]
            ddl = ls.dl_rel(nb, base) - ls.dl_rel(bits[p], base)
            if acc_budget is not None and total_dl + ddl > acc_budget:
                continue
            dsec = table.leaf_seconds(p, bits[p]) - table.leaf_seconds(p, nb)
            score = dsec / max(ddl, eps)
            if score > best_score:
                best, best_score = (p, nb, ddl), score
        if best is None:
            break
        p, nb, ddl = best
        bits[p] = nb
        total_dl += ddl
    return bits


def uniform_bits_for_budget(table: SensitivityTable, acc_budget: float,
                            cfg: AutoBitsConfig = AutoBitsConfig()) -> int:
    """The lowest uniform width whose predicted loss fits the budget — the
    matched-budget baseline the mixed plan must beat on modeled cost."""
    best = table.spec.bits
    for b in _ladder(table, cfg):
        if table.plan_dl({p: b for p in table.leaves}) <= acc_budget:
            best = b
    return best


def plan_auto_bits(model: Any, params: Any, spec: FormsSpec = FormsSpec(),
                   cfg: AutoBitsConfig = AutoBitsConfig(),
                   calib: Optional[Sequence[torch.Tensor]] = None,
                   table: Optional[SensitivityTable] = None,
                   validate: bool = True) -> AutoBitsPlan:
    """Sensitivity pass and throughput-max allocation under
    ``cfg.acc_budget`` (``table=`` reuses one sweep).

    With ``validate=True`` the plan's NLL delta is measured on the
    calibration stream, and when the quadratic model undercounted it the
    allocation backs off: the internal budget shrinks by the miss ratio and
    the greedy solves again, at most 4 rounds, ending at a plan whose
    measured delta fits the budget or at the uniform base tree.
    """
    if table is None:
        table = measure_sensitivity(model, params, spec, cfg, calib)
    base_seconds = uniform_seconds(table, table.spec.bits)
    if not validate:
        bits = solve_bits(table, cfg, acc_budget=cfg.acc_budget)
        return AutoBitsPlan(
            spec=table.spec, bits=bits, predicted_dl=table.plan_dl(bits),
            acc_budget=cfg.acc_budget, modeled_seconds=table.plan_seconds(bits),
            base_seconds=base_seconds, table=table)
    if _has_forms_leaves(params):
        params = decompress_tree(params)
    if calib is None:
        calib = random_calibration(model.config.vocab_size, cfg, model.device)
    with torch.no_grad():
        base_comp, _ = compress_tree(params, table.spec)
    nll_base = measured_nll(model, base_comp, calib)
    del base_comp
    internal = cfg.acc_budget
    bits = {p: table.spec.bits for p in table.leaves}
    measured = 0.0
    for _ in range(4):
        cand = solve_bits(table, cfg, acc_budget=internal)
        predicted = table.plan_dl(cand)
        if all(b == table.spec.bits for b in cand.values()):
            bits, measured = cand, 0.0
            break
        with torch.no_grad():
            comp, _ = compress_tree(params, table.spec,
                                    plan={p: table.spec.with_bits(b) for p, b in cand.items()})
        delta = measured_nll(model, comp, calib) - nll_base
        del comp
        if delta <= cfg.acc_budget:
            bits, measured = cand, delta
            break
        # undercount: shrink the internal budget by the miss ratio (with a
        # safety margin) and solve again on the same table
        miss = delta / max(predicted, 1e-12)
        internal = min(internal * 0.5, 0.8 * cfg.acc_budget / miss)
    return AutoBitsPlan(
        spec=table.spec, bits=bits, predicted_dl=table.plan_dl(bits),
        acc_budget=cfg.acc_budget, modeled_seconds=table.plan_seconds(bits),
        base_seconds=base_seconds, measured_dl=measured, table=table)


def plan_draft_bits(table: SensitivityTable, match_bits: int = 4,
                    cfg: AutoBitsConfig = AutoBitsConfig()) -> AutoBitsPlan:
    """The speculative draft's plan: least predicted loss at the modeled
    cost of a uniform ``match_bits`` draft, or that uniform plan itself
    where the greedy lands above its predicted loss."""
    target = uniform_seconds(table, match_bits)
    bits = solve_bits(table, cfg, seconds_target=target)
    uniform = {p: match_bits for p in table.leaves}
    if table.plan_dl(bits) > table.plan_dl(uniform):
        bits = uniform
    return AutoBitsPlan(
        spec=table.spec, bits=bits, predicted_dl=table.plan_dl(bits),
        acc_budget=float("inf"), modeled_seconds=table.plan_seconds(bits),
        base_seconds=uniform_seconds(table, table.spec.bits),
        matched_uniform=match_bits, table=table)


# ---------------------------------------------------------------------------
# checkpoint round-trip (extra_meta helpers)
# ---------------------------------------------------------------------------


def plan_to_meta(spec: FormsSpec, plan: Dict[str, FormsSpec]) -> dict:
    """Checkpoint metadata of a heterogeneous tree: the base spec's fields
    and, per path, the fields that differ from it."""
    base = dataclasses.asdict(spec)
    overrides = {}
    for p, s in plan.items():
        d = dataclasses.asdict(s)
        overrides[p] = {k: v for k, v in d.items() if v != base[k]}
    return {"spec": base, "plan": overrides}


def plan_from_meta(meta: dict) -> Tuple[FormsSpec, Dict[str, FormsSpec]]:
    """Inverse of :func:`plan_to_meta`, for either package's meta: the base
    spec and the plan that ``compress_tree(init, spec, plan=plan)`` turns
    into the restore template.  The reference's ``prefer_ref`` is taken as
    :func:`~repro_torch.forms.spec.spec_from_meta` takes it."""
    spec = spec_from_meta({k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in meta["spec"].items()})
    base = dataclasses.asdict(spec)
    plan = {p: spec_from_meta({**base, **ov}) for p, ov in meta["plan"].items()}
    return spec, plan
