"""Serving-time health monitoring and self-healing for corrupted arrays.

ReRAM faults (``reliability/faults.py``) corrupt the weights the engine is
serving, silently: requests keep completing, the logits are just wrong.
This module gives the serving engine the feedback loop:

* **Golden probes**: at engine build a :class:`HealthMonitor` captures the
  last-token logits of a few fixed probe prompts from the clean params (one
  small forward each, under the engine's spec).  At run start and every
  ``probe_every`` decode rounds the scheduler re-runs the probes; the
  max-abs logit drift against the golden copy is the health signal.
* **Scoreboard**: on drift past ``drift_threshold`` the monitor compares
  every compressed leaf against its host copy of the clean planes (the
  reference checkpoint, read back at build) and scores each by mismatched
  codes and signs; ``replicas`` names the device that serves them.
* **Repair**: with ``auto_repair`` the clean planes of every flagged leaf
  go back onto the leaf's device and the runner's params are rebound.  The
  repaired tree has the same shapes, dtypes and devices, and nothing else
  changes: the KV cache, the slots and the positions stay as they are, so
  requests in flight go on with the repaired weights.

The JAX package's ``reliability/health.py``, held to it on the CPU.  On a
mesh (``ctx=``) every rank keeps the reference planes of its own shards and
scores them; the ranks' scores are gathered, so every rank holds the whole
scoreboard, whose ``replicas`` key each rank as ``"<device type>:<rank>"``
(``"cpu:1"``, ``"cuda:0"``) where the reference keys a device's shard by
``str(shard.device)``.  A probe's drift is the largest over the ranks, so
all ranks take the same decision, and repair re-encodes only the shards
that differ from their reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed.context import parallel_context
from repro_torch.forms.linear import default_spec
from repro_torch.forms.tree import compressed_paths
from repro_torch.reliability.faults import (FaultModel, FaultReport, inject_tree,
                                            replace_leaves)

EVENT_LOG_WINDOW = 256    # health events retained; older ones are counted

__all__ = ["HealthConfig", "HealthMonitor"]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that no live tensor shares (``.cpu()`` of a CPU tensor
    would be a view)."""
    return t.detach().to("cpu", copy=True).numpy()


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the serving-time health loop.

    probe_every: decode rounds between probe passes (0 = probe only at
      run start).
    drift_threshold: max-abs logit drift that flags the params as
      corrupted (stuck cells produce drifts orders of magnitude past it).
    auto_repair: re-encode flagged leaves from the reference copy as soon
      as the scan localizes them (False = detect and score only).
    probe_tokens: length of each synthetic probe prompt.
    n_probes: number of probe prompts.
    probe_seed: RNG seed for the synthetic probe prompts.
    """

    probe_every: int = 16
    drift_threshold: float = 1e-3
    auto_repair: bool = True
    probe_tokens: int = 8
    n_probes: int = 2
    probe_seed: int = 1234

    def __post_init__(self):
        if self.probe_every < 0:
            raise ValueError(f"probe_every must be >= 0, "
                             f"got {self.probe_every}")
        if self.drift_threshold <= 0:
            raise ValueError(f"drift_threshold must be > 0, "
                             f"got {self.drift_threshold}")
        if self.probe_tokens < 1 or self.n_probes < 1:
            raise ValueError("need at least one probe prompt of length >= 1")


class HealthMonitor:
    """Golden-probe drift detection + reference-copy repair for one engine.

    Built by :class:`~repro_torch.serving.engine.ServingEngine` after
    compression, over the tree the runner serves, so the golden logits and
    the reference planes describe the real serving artifact.
    """

    def __init__(self, model: Any, params: Any, config: HealthConfig, *,
                 spec: Any = None, ctx: Any = None):
        if tuple(model.input_fields) != ("tokens",):
            raise ValueError(
                f"health monitoring probes token prompts, but family "
                f"{model.config.family!r} consumes inputs "
                f"{model.input_fields} — serve it without health=..., or "
                f"extend HealthMonitor with a probe-batch builder for it")
        self.config = config
        self.model = model
        self.spec = spec
        self.ctx = ctx
        self.probes = 0
        self.repairs = 0
        self.last_drift = 0.0
        self.flagged: Dict[str, Dict[str, Any]] = {}   # last scan's scoreboard
        # rotating window: a sustained-load run ticks for hours; keep the
        # recent events, count the ones that rolled off
        self.events: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=EVENT_LOG_WINDOW)
        self.events_dropped = 0
        self._chaos: List[Tuple[int, FaultModel, Optional[Sequence[str]]]] = []
        self.fault_reports: List[FaultReport] = []

        rng = np.random.default_rng(config.probe_seed)
        vocab = int(model.config.vocab_size)
        self._prompts = [
            torch.from_numpy(rng.integers(0, vocab, size=(1, config.probe_tokens),
                                          dtype=np.int64).astype(np.int32)).to(model.device)
            for _ in range(config.n_probes)]
        # the reference checkpoint: host copies of the clean integer planes
        # (scale and the float metadata are not corruptible by the fault
        # model, so this is a few uint8/int8 planes, not a params copy)
        self._reference: Dict[str, Dict[str, np.ndarray]] = {
            path: {"mags": _host_copy(leaf.mags), "signs": _host_copy(leaf.signs)}
            for path, leaf in compressed_paths(params).items()}
        if not self._reference:
            raise ValueError(
                "health monitoring needs a compressed params tree (no "
                "FormsLinearParams leaves found) — build the engine with "
                "forms=True / spec=..., or drop health=...")
        self._golden = [self._run_probe(params, t) for t in self._prompts]

    # ------------------------------------------------------------------
    # probes
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _run_probe(self, params: Any, toks: torch.Tensor) -> np.ndarray:
        """The last token's logits of one probe prompt, f32 on the host."""
        with default_spec(self.spec), parallel_context(self.ctx):
            logits, _ = self.model.forward(params, {"tokens": toks})
        return logits[:, -1].float().cpu().numpy()

    def probe(self, params: Any) -> float:
        """Max-abs last-token logit drift across the probe prompts."""
        self.probes += 1
        drift = 0.0
        for toks, golden in zip(self._prompts, self._golden):
            cur = self._run_probe(params, toks)
            drift = max(drift, float(np.max(np.abs(cur - golden))))
        if self.ctx is not None:
            drift = max(self.ctx.gather_objects(drift))
        self.last_drift = drift
        return drift

    # ------------------------------------------------------------------
    # scan / scoreboard
    # ------------------------------------------------------------------

    def _mismatch(self, params: Any) -> Dict[str, Tuple[int, int, int]]:
        """path -> (bad codes, bad signs, cells) of this rank's planes."""
        out = {}
        for path, leaf in compressed_paths(params).items():
            ref = self._reference[path]
            mags = leaf.mags.cpu().numpy()
            signs = leaf.signs.cpu().numpy()
            out[path] = (int((mags != ref["mags"]).sum()), int((signs != ref["signs"]).sum()),
                         int(mags.size))
        return out

    def _replica_key(self, leaf: Any) -> str:
        if self.ctx is None:
            return str(leaf.mags.device)
        return f"{leaf.mags.device.type}:{self.ctx.rank}"

    def scan(self, params: Any) -> Dict[str, Dict[str, Any]]:
        """Compare every compressed leaf against the reference copy; returns
        and records the scoreboard of corrupted leaves.  ``replicas`` maps
        the device (on a mesh: the rank) that holds a corrupted shard to its
        mismatched codes; counts and cells add up over the ranks."""
        live = compressed_paths(params)
        mine = {p: (*v, self._replica_key(live[p])) for p, v in self._mismatch(params).items()}
        ranks = self.ctx.gather_objects(mine) if self.ctx is not None else [mine]
        board: Dict[str, Dict[str, Any]] = {}
        for path in live:
            rows = [r[path] for r in ranks]
            bad_codes = sum(r[0] for r in rows)
            bad_signs = sum(r[1] for r in rows)
            if not bad_codes and not bad_signs:
                continue
            board[path] = {
                "bad_codes": bad_codes, "bad_signs": bad_signs,
                "frac_codes": bad_codes / max(1, sum(r[2] for r in rows)),
                "replicas": {r[3]: r[0] for r in rows if r[0]}}
        self.flagged = board
        return board

    # ------------------------------------------------------------------
    # repair
    # ------------------------------------------------------------------

    def repair(self, params: Any, paths: Sequence[str]) -> Any:
        """Re-encode ``paths`` from the reference copy; returns the repaired
        tree (only the flagged leaves replaced, each with its shapes, dtypes
        and device, so rebinding it into a live runner changes nothing
        else).  On a mesh a rank replaces its shard of a flagged leaf only
        where that shard differs from its reference."""
        wanted = set(paths)
        missing = wanted - set(self._reference)
        if missing:
            raise ValueError(f"no reference copy for {sorted(missing)} — "
                             f"known leaves: {sorted(self._reference)}")
        live = compressed_paths(params)
        bad = self._mismatch(params) if self.ctx is not None else None
        new = {}
        for p in wanted:
            if bad is not None and not any(bad[p][:2]):
                continue
            leaf, ref = live[p], self._reference[p]
            new[p] = dataclasses.replace(
                leaf, mags=torch.from_numpy(ref["mags"]).to(leaf.mags.device, copy=True),
                signs=torch.from_numpy(ref["signs"]).to(leaf.signs.device, copy=True))
        self.repairs += len(wanted)
        return replace_leaves(params, new)

    # ------------------------------------------------------------------
    # chaos scheduling (tests / demos: faults that strike mid-run)
    # ------------------------------------------------------------------

    def schedule_fault(self, round_: int, fault: FaultModel,
                       paths: Optional[Sequence[str]] = None) -> None:
        """Arrange for ``fault`` to strike at decode round ``round_`` of the
        next :meth:`tick`-driven run: chaos injection while requests are in
        flight."""
        self._chaos.append((int(round_), fault, paths))

    def _fire_chaos(self, runner: Any, round_: int) -> None:
        due = [c for c in self._chaos if c[0] <= round_]
        self._chaos = [c for c in self._chaos if c[0] > round_]
        for _, fault, paths in due:
            runner.params, report = inject_tree(runner.params, fault,
                                                spec=self.spec, paths=paths)
            self.fault_reports.append(report)
            self._log_event({"round": round_, "event": "chaos",
                             "detail": report.summary()})

    # ------------------------------------------------------------------
    # the scheduler hook
    # ------------------------------------------------------------------

    @obs.spanned("rt.sched.health")
    def tick(self, runner: Any, round_: int) -> None:
        """One health pass: fire due chaos faults, probe, and past the drift
        threshold scan, score and (``auto_repair``) re-encode the flagged
        leaves into the live runner."""
        self._fire_chaos(runner, round_)
        drift = self.probe(runner.params)
        if drift <= self.config.drift_threshold:
            return
        t0 = time.perf_counter()
        board = self.scan(runner.params)
        self._log_event({
            "round": round_, "event": "drift", "drift": drift,
            "leaves": sorted(board)})
        if not self.config.auto_repair or not board:
            return
        runner.params = self.repair(runner.params, sorted(board))
        drift_after = self.probe(runner.params)
        self._log_event({
            "round": round_, "event": "repair", "leaves": sorted(board),
            "drift_after": drift_after,
            "ms": (time.perf_counter() - t0) * 1e3})

    def _log_event(self, event: Dict[str, Any]) -> None:
        if len(self.events) == self.events.maxlen:
            self.events_dropped += 1
        self.events.append(event)

    def stats(self) -> Dict[str, Any]:
        """The ``engine.stats()["health"]`` payload."""
        return {
            "probes": self.probes,
            "repairs": self.repairs,
            "last_drift": self.last_drift,
            "flagged": self.flagged,
            "events": list(self.events),
            "events_dropped": self.events_dropped,
        }

