"""Offline batch serving: the window is a series of consecutive
``ServingEngine.run`` calls, each on the next batch of the seeded stream,
until the window's seconds have passed (the call that crosses the mark
finishes: an offline job pays its drain).

Set-up: the card, the kernels' builds (cached in the checkout), the dense
weights drawn on the device from the seed, the engine (it compresses them
to FORMS codes), and one warm call over every prefill shape the mix
reaches.  The window: ``serve_tok_s`` is every prompt and generated token
of the returned requests over the window's wall time; ``peak_mem_gb`` the
allocator's peak over the window.  A traced run installs the spans that the
cell's per-layer metrics read (``spans/``) for its window and then
profiles one more call of the stream.
Afterwards the program is freed and the reference judges a sample of the
window's requests (``reference/serve_check.py``)."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from port_bench.harness import spec as S
from port_bench.harness import traffic as TR
from port_bench.harness import spans as SP
from port_bench.harness.spans import Spans
from port_bench.harness.trace import TraceReading, kineto_events, profile_call, read
from port_bench.harness.weights import program_params
from port_bench.reference import serve_check


@dataclasses.dataclass
class Measurement:
    """What a run measured, before it is put into a result line."""
    cell: S.Cell
    seed: int
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    served: List[Tuple[int, int]]           # (prompt tokens, generated tokens)
    peak_window: Optional[int]
    peak_setup: Optional[int]
    checks: List[Dict[str, Any]]
    spans: Optional[Spans] = None
    trace: Optional[TraceReading] = None
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)    # window spans
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)  # control too

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks)

    @property
    def tokens(self) -> int:
        return sum(p + o for p, o in self.served)


def build(cell: S.Cell, seed: int, device):
    """The program's engine over the seeded weights."""
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.forms import FormsSpec
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine

    cfg = ModelConfig(**cell.port)
    model = registry.build(cfg, device=device)
    params = program_params(S.reference(cell.config), cell.port, seed, device)
    eng_kw = dict(cell.traffic["engine"])
    forms = cell.config["forms"]
    engine = ServingEngine(model, params, device=device, rng_seed=seed,
                           spec=FormsSpec(m=forms["m"], bits=forms["bits"],
                                          rule=forms["rule"]), **eng_kw)
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return engine


def _requests(batch: TR.Batch, j: int):
    from repro_torch.serving.engine import Request
    return [Request(uid=j * 100_000 + i, prompt=p, max_new_tokens=o, temperature=0.0)
            for i, (p, o) in enumerate(batch)]


def _served_ok(batch: TR.Batch, results) -> Tuple[List, int]:
    """(finished (prompt, tokens) pairs, how many requests failed: not
    returned, or returned with another number of tokens than asked)."""
    by_uid = {r.uid % 100_000: r for r in results}
    finished, failed = [], 0
    for i, (p, o) in enumerate(batch):
        r = by_uid.get(i)
        if r is None or len(r.tokens) != o:
            failed += 1
            continue
        finished.append((p, list(r.tokens)))
    return finished, failed


def measure(cell: S.Cell, seed: int, seconds: float, trace: bool, t0: float,
            device="cuda", precisions=("f32",)) -> Measurement:
    """One run: set-up, the window (and with ``trace`` the spans and one
    profiled call), then the reference's judgement; ``precisions`` adds
    the control's readings (``fp8``) to ``Measurement.readings``."""
    import torch

    on_card = torch.device(device).type == "cuda"
    vocab = cell.port["vocab_size"]
    mix = cell.traffic
    engine = build(cell, seed, device)
    warm = TR.warm_batch(mix, vocab, seed, engine.runner.bucket_for)
    engine.run(_requests(warm, 9_999))
    if on_card:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
    setup_s = time.perf_counter() - t0

    spans = (SP.install(cell.span_names(), cell.bench_dir, markers=on_card,
                        state={"forms_m": cell.config["forms"]["m"]}) if trace else None)
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        finished, failed, attempted, j = [], 0, 0, 0
        t_start = time.perf_counter()
        while True:
            batch = TR.batch(mix, vocab, seed, j)
            results = engine.run(_requests(batch, j))
            done, bad = _served_ok(batch, results)
            finished += done
            failed += bad
            attempted += len(batch)
            j += 1
            if time.perf_counter() - t_start >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
        peak_window = torch.cuda.max_memory_allocated() if on_card else None
        host_s = dict(spans.host_s) if trace else {}
        counters = dict(spans.counters) if trace else {}

        reading = None
        if trace:
            batch = TR.batch(mix, vocab, seed, j)
            with spans.record():
                results, wall, prof = profile_call(lambda: engine.run(_requests(batch, j)),
                                                    on_card)
            failed += _served_ok(batch, results)[1]
            attempted += len(batch)
            reading = read(kineto_events(prof), wall, spans.names)
            print(f"trace: {reading.summary}", file=sys.stderr, flush=True)
            del prof
    finally:
        if spans is not None:
            spans.uninstall()

    served = [(len(p), len(t)) for p, t in finished]
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    chk = cell.limits["check"]
    picked = [finished[i] for i in serve_check.sample(finished, seed, chk["sample_requests"],
                                                      TR.CHECK_STREAM)]
    got = serve_check.gaps(S.reference(cell.config), cell.port, seed, picked,
                           cell.config["forms"], precisions=precisions, device=device)
    readings = {f"served_logit_gap_{stat}" + ("" if p == "f32" else f".{p}"): v
                for stat, by_p in got.items() for p, v in by_p.items()}
    checks = [{"name": "failed_requests", "value": failed, "limit": 0}]
    checks += [{"name": k, "value": readings[k], "limit": lim}
               for k, lim in cell.limits.items() if k != "check"]
    return Measurement(cell=cell, seed=seed, setup_s=setup_s, window_s=window_s,
                       attempted=attempted, failed=failed, served=served,
                       peak_window=peak_window, peak_setup=peak_setup if on_card else None,
                       checks=checks, spans=spans, trace=reading,
                       host_s=host_s, counters=counters, readings=readings)


def end_to_end(m: Measurement) -> Dict[str, float]:
    return {"setup_s": m.setup_s,
            "serve_tok_s": m.tokens / m.window_s,
            "peak_mem_gb": m.peak_window / 1e9}
