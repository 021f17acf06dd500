"""Training: the program's train step (``training/train_loop.make_train_step``)
driven as its launcher drives it, one step per batch of the seeded token
stream, then ``maybe_admm_update`` (the ADMM Z/U update every
``admm_update_every`` steps).

Set-up builds the one train state from the seeded weights and drives it
through the first ``check.steps`` steps and the Z-update that follows them
(so the window starts warm, the polarization kernel built), recording what
the reference judges: each step's loss, each leaf's first gradient as
AdamW got it (its first moment after one step over 1 - beta1), each leaf's
change over those steps, and the Z of a seeded sample of (leaf, layer)
matrices beside the weights it was projected from.  The window runs the
same state on: ``train_tok_s`` is the tokens of every step in it over its
wall time (the device synchronized at its end), ``peak_mem_gb`` the
allocator's peak.  A traced run installs the spans that the cell's
per-layer metrics read (``spans/``: the Z-updates timed with a
synchronize on both sides) and profiles one more step after the
window."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from port_bench.harness import spec as S
from port_bench.harness.lmdata import lm_tokens
from port_bench.harness import spans as SP
from port_bench.harness.trace import TraceReading, kineto_events, profile_call, read
from port_bench.harness.weights import program_params
from port_bench.reference import decoder as D
from port_bench.reference import train_ref

STEP_RANGE = "pb.train_step"       # the driver's own range around a step
Z_STREAM = 4 << 32


@dataclasses.dataclass
class Measurement:
    cell: S.Cell
    seed: int
    setup_s: float
    window_s: float
    steps: int                      # steps in the window
    attempted: int
    failed: int
    peak_window: Optional[int]
    peak_setup: Optional[int]
    checks: List[Dict[str, Any]]
    readings: Dict[str, float]      # the compared numbers, control readings too
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[TraceReading] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c["value"] <= c["limit"] for c in self.checks)

    @property
    def tokens_per_step(self) -> int:
        return int(self.cell.traffic["batch"]) * int(self.cell.traffic["seq_len"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _batch(cell: S.Cell, seed: int, step: int, device):
    import torch
    toks = lm_tokens(cell.traffic, cell.port["vocab_size"], seed, step)
    return {"tokens": torch.from_numpy(toks).to(device)}


def z_sample(cell: S.Cell, seed: int, n: int):
    """(path, layer) of ``n`` constrained matrices drawn from the seed."""
    cfg = cell.port
    cands = [(p, i) for p in train_ref.constrained(cfg) if p.startswith("blocks/")
             for i in range(cfg["num_layers"])]
    rng = np.random.default_rng([int(seed), Z_STREAM])
    return [cands[int(j)] for j in rng.choice(len(cands), size=n, replace=False)]


def measure(cell: S.Cell, seed: int, seconds: float, trace: bool, t0: float,
            device="cuda", precisions=("f32",)) -> Measurement:
    import torch
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.models import registry
    from repro_torch.training import train_loop

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mix, cfg = cell.traffic, cell.port
    chk = cell.limits["check"]
    n_check = int(chk["steps"])
    model = registry.build(ModelConfig(**cfg), device=device)
    tcfg = TrainConfig(**mix["job"])
    params = program_params(D, cfg, seed, device)
    state, table = train_loop.init_train_state(model, tcfg, seed=seed, params=params)
    del params
    step_fn = train_loop.make_train_step(model, tcfg, table)

    if tcfg.admm_update_every != n_check:
        raise ValueError("the check reads the first Z-update, due right after the "
                         f"{n_check} checked steps (admm_update_every)")
    losses = []
    grad1: Dict[str, float] = {}
    for i in range(1, n_check + 1):
        state, met = step_fn(state, _batch(cell, seed, i, device))
        losses.append(met["loss"])
        if i == 1:
            with torch.no_grad():
                grad1 = {p: float(torch.linalg.vector_norm(m.float())) / (1 - tcfg.beta1)
                         for p, m in _leaves(state.opt.mu)}
        state = train_loop.maybe_admm_update(state, table, tcfg, i)
    losses = [float(x) for x in losses]
    with torch.no_grad():
        change = _change_norms(state.params, cfg, seed, device)
        by_path = dict(_leaves(state.params))
        zs = [(by_path[p][i].to("cpu", torch.float32, copy=True),
               state.admm[p].z[i].to("cpu", torch.float32, copy=True))
              for p, i in z_sample(cell, seed, int(chk["z_samples"]))]
    sync()
    peak_setup = torch.cuda.max_memory_allocated() if on_card else None
    setup_s = time.perf_counter() - t0

    spans = SP.install(cell.span_names(), cell.bench_dir) if trace else None
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        i = n_check + 1
        t_start = time.perf_counter()
        steps = 0
        while True:
            state, met = _step(step_fn, state, _batch(cell, seed, i, device), trace)
            state = train_loop.maybe_admm_update(state, table, tcfg, i)
            steps += 1
            i += 1
            if time.perf_counter() - t_start >= seconds:
                break
        last_loss = float(met["loss"])
        sync()
        window_s = time.perf_counter() - t_start
        peak_window = torch.cuda.max_memory_allocated() if on_card else None
        host_s = dict(spans.host_s) if trace else {}
        counters = dict(spans.counters) if trace else {}
        reading = None
        if trace:
            batch = _batch(cell, seed, i, device)
            (state, met), wall, prof = profile_call(lambda: _step(step_fn, state, batch, True),
                                                    on_card)
            reading = read(kineto_events(prof), wall, [STEP_RANGE] + spans.names)
            print(f"trace: {reading.summary}", file=sys.stderr, flush=True)
            del prof
    finally:
        if spans is not None:
            spans.uninstall()
    failed = 0 if np.isfinite(last_loss) else 1
    del state, step_fn, met
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    batches = [torch.from_numpy(lm_tokens(mix, cfg["vocab_size"], seed, k))
               for k in range(1, n_check + 1)]
    ref = train_ref.train_steps(cfg, seed, batches, mix["job"], device=device)
    worst: Dict[str, str] = {}
    readings = compare({"losses": losses, "grad1": grad1, "change": change}, ref, worst)
    readings["z_update_gap"] = z_gap(zs, mix["admm_sets"])
    for prec in precisions:
        if prec == "half":
            # the fault "half of the batch left out, the mean over the rest",
            # planted in the reference put in the program's place
            bad = train_ref.train_steps(cfg, seed, [b[: b.shape[0] // 2] for b in batches],
                                        mix["job"], device=device)
            readings.update({f"{k}.half": v for k, v in compare(bad, ref).items()})
            # the Z-update returning its state unchanged: Z stays the weights
            readings["z_update_gap.unchanged"] = z_gap([(w, w) for w, _ in zs],
                                                       mix["admm_sets"])
        elif prec != "f32":
            ctl = train_ref.train_steps(cfg, seed, batches, mix["job"], precision=prec,
                                        device=device)
            readings.update({f"{k}.{prec}": v for k, v in compare(ctl, ref).items()})
    print(f"worst leaves: {worst}", file=sys.stderr, flush=True)
    checks = [{"name": k, "value": readings[k], "limit": lim}
              for k, lim in cell.limits.items() if k != "check"]
    return Measurement(cell=cell, seed=seed, setup_s=setup_s, window_s=window_s,
                       steps=steps, attempted=steps, failed=failed, peak_window=peak_window,
                       peak_setup=peak_setup, checks=checks, readings=readings,
                       host_s=host_s, counters=counters, trace=reading)


def _step(step_fn, state, batch, trace: bool):
    if not trace:
        return step_fn(state, batch)
    import torch
    with torch.profiler.record_function(STEP_RANGE):
        return step_fn(state, batch)


def compare(got: Dict, ref: Dict, worst: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """The numbers a training cell can compare: the first step's and the
    widest relative gap of the step losses; of the first-gradient and
    change norms, the worst leaf's gap and the median leaf's, each leaf's
    gap taken over the larger of its reference norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (a key's bias under softmax) carry rounding alone, and are left
    out.  ``worst`` receives the leaf that set each worst gap."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    out = {"loss1_gap": rel[0], "loss_gap": max(rel)}
    g_med = float(np.median(list(ref["grad1"].values())))
    live = [p for p, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    for key in ("grad1", "change"):
        med = float(np.median([ref[key][p] for p in live]))
        gaps = {p: abs(got[key][p] - ref[key][p]) / max(ref[key][p], med) for p in live}
        leaf = max(gaps, key=gaps.get)
        out[f"{key}_gap"] = gaps[leaf]
        out[f"{key}_gap_med"] = float(np.median(list(gaps.values())))
        if worst is not None:
            worst[key] = leaf
    return out


def z_gap(zs, sets: Dict) -> float:
    """The sampled matrices' Z after the first Z-update against the
    reference's projection of the program's own weights (U is zero before
    the first update): the worst relative L2 gap."""
    import torch
    worst = 0.0
    for w, z in zs:
        ref = train_ref.project(w, int(sets["m"]), int(sets["bits"]))
        worst = max(worst, float(torch.linalg.vector_norm(z - ref)
                                 / torch.clamp(torch.linalg.vector_norm(ref), min=1e-30)))
    return worst


def _change_norms(params, cfg: Dict, seed: int, device) -> Dict[str, float]:
    """Each leaf's change from the seeded weights (drawn again layer by
    layer)."""
    import torch
    layer, top = D.layout(cfg)
    spec_ = {p: (shape, init) for p, shape, init, _ in layer + top}
    out = {}
    for path, w in _leaves(params):
        shape, init = spec_[path]
        if path.startswith("blocks/"):
            sq = sum(float(torch.sum((w[i].float()
                                      - D.draw(seed, path, i, shape, init, device)) ** 2))
                     for i in range(cfg["num_layers"]))
        else:
            sq = float(torch.sum((w.float() - D.draw(seed, path, 0, shape, init, device)) ** 2))
        out[path] = sq ** 0.5
    return out


def end_to_end(m: Measurement) -> Dict[str, float]:
    return {"setup_s": m.setup_s,
            "train_tok_s": m.steps * m.tokens_per_step / m.window_s,
            "peak_mem_gb": m.peak_window / 1e9}
