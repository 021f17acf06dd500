"""Self-speculative decoding: a low-bit draft of the served weights, verified
by the target on the paged serving engine, in PyTorch.

Every FORMS-served model holds its own draft: the target's weights
re-quantized to 4-bit magnitudes (on the target's fragments, or others),
optionally keeping only every n-th layer.

* :func:`make_draft_tree` / :func:`make_draft` — the draft tree, through
  ``repro_torch.forms.compress_tree`` (``mode="forms"``: served by the
  polarized-matmul kernel like the target) or the int grid of
  ``serving/quant_weights.py`` (``mode="int"``: dequantize + matmul).
* :class:`SpeculativeRunner` — a :class:`~repro_torch.serving.engine.
  ModelRunner` whose round runs K+1 draft decode calls on the draft's own
  page pool, one target ``decode_paged`` over the (B, K+1) tokens, and the
  acceptance (:func:`_accept`), all on the device; the host reads the
  emitted grid and the counts once per round.  Greedy acceptance gives the
  plain engine's tokens; temperature rows accept by rejection sampling,
  whose outcome distribution is the target's
  (:func:`rejection_outcome_probs`).
* Per-slot adaptive K — an acceptance EWMA per slot shrinks the slot's
  eligible draft length when acceptance drops and grows it back when the
  draft is hot; a round's width is the largest eligible K of the active
  slots.

Rollback: a round writes K+1 rows at ``pos .. pos+K`` into both pools.
When verification accepts ``n``, the scheduler moves the slot's cursor to
``pos + n + 1``; the rejected rows are dead, since every decode mask admits
only ``kpos <= pos`` and every row is rewritten before its position enters
a mask (``kv_cache.rollback_tokens`` scrubs them for auditing).  The draft
pool shares the target's block tables, so the pools stay in step; the
draft runs one extra step so that a fully accepted round leaves the row of
``d_K`` written.  Chunked admission (the fleet scheduler's
:meth:`SpeculativeRunner.prefill_chunk`) advances both pools by the same
chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.forms import (CompressReport, FormsLinearParams, FormsSpec, compress_tree,
                               decompress_tree, default_spec, sparsity_stats)
from repro_torch.models.registry import Model, build
from repro_torch.serving import kv_cache as KV
from repro_torch.serving.engine import ModelRunner, gumbel_argmax, sample_on_device
from repro_torch.serving.quant_weights import quantize_tree


@dataclasses.dataclass(frozen=True)
class SpeculateConfig:
    """One speculative-decoding configuration.

    k: the most draft tokens verified per round (the verify is K+1 wide).
    bits: draft magnitude bits.  mode: ``"forms"`` (``compress_tree`` at
    ``bits`` on fragments of ``fragment`` rows; None keeps the default m)
    or ``"int"`` (the symmetric int grid).  layer_step: keep every
    ``layer_step``-th layer (1 = full depth; random weights need full
    depth).  adaptive / k_min / low / high / ewma: per-slot adaptive K — an
    acceptance EWMA per slot; below ``low`` the slot's K shrinks by one
    (floor ``k_min``), above ``high`` it grows back (ceiling ``k``).
    """

    k: int = 4
    bits: int = 4
    mode: str = "forms"
    fragment: Optional[int] = None
    layer_step: int = 1
    adaptive: bool = True
    k_min: int = 1
    low: float = 0.4
    high: float = 0.8
    ewma: float = 0.5

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"draft k must be >= 1, got {self.k}")
        if self.mode not in ("forms", "int"):
            raise ValueError(f"draft mode must be 'forms' or 'int', got {self.mode!r}")
        if self.layer_step < 1:
            raise ValueError(f"layer_step must be >= 1, got {self.layer_step}")
        if not 1 <= self.k_min <= self.k:
            raise ValueError(f"k_min={self.k_min} must be in [1, k={self.k}]")


# ---------------------------------------------------------------------------
# draft derivation
# ---------------------------------------------------------------------------


def _has_forms_leaves(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_forms_leaves(v) for v in tree.values())
    return isinstance(tree, FormsLinearParams)


def _take_layers(tree: Any, keep: torch.Tensor) -> Any:
    if isinstance(tree, dict):
        return {k: _take_layers(v, keep) for k, v in tree.items()}
    if isinstance(tree, FormsLinearParams):
        return dataclasses.replace(tree, mags=tree.mags[keep], signs=tree.signs[keep],
                                   scale=tree.scale[keep])
    return tree[keep]


def skip_layers(model: Model, params: Any, layer_step: int) -> Tuple[Model, Any]:
    """Keep every ``layer_step``-th stacked block layer (layer 0 always):
    slices the leading layer axis of every leaf under ``blocks`` (FORMS
    leaves slice their planes together) and rebuilds the model at the
    reduced depth on the same device.  Other leaves are shared."""
    if layer_step <= 1:
        return model, params
    cfg = model.config
    keep = torch.arange(0, cfg.num_layers, layer_step)
    out = dict(params)
    out["blocks"] = _take_layers(params["blocks"], keep.to(model.device))
    return build(dataclasses.replace(cfg, num_layers=int(keep.numel())), model.device), out


def make_draft_tree(params: Any, spec: Optional[FormsSpec] = None, *, bits: int = 4,
                    mode: str = "forms") -> Tuple[Any, CompressReport]:
    """The low-bit draft of ``params``: ``mode="forms"`` compresses at
    ``spec`` (default ``FormsSpec(bits=bits)``), ``mode="int"`` quantizes
    to the symmetric ``bits`` grid.  An already-compressed tree is
    decompressed first, so a 4-bit draft of an 8-bit tree re-quantizes the
    float projection instead of aliasing the 8-bit leaves."""
    if _has_forms_leaves(params):
        params = decompress_tree(params)
    if mode == "int":
        tree, before, after = quantize_tree(params, bits=bits)
        return tree, CompressReport(errors={}, bytes_dense=before, bytes_compressed=after)
    if mode != "forms":
        raise ValueError(f"draft mode must be 'forms' or 'int', got {mode!r}")
    return compress_tree(params, spec if spec is not None else FormsSpec(bits=bits))


def make_draft(model: Model, params: Any, cfg: SpeculateConfig
               ) -> Tuple[Model, Any, CompressReport]:
    """Layer skipping + low-bit weights: ``(draft_model, draft_params,
    report)``.  A compressed target is decompressed before slicing, so the
    draft approximates what the target serves; the dense tree is dropped
    on return."""
    if _has_forms_leaves(params):
        params = decompress_tree(params)
    draft_model, draft_params = skip_layers(model, params, cfg.layer_step)
    spec = (FormsSpec(m=cfg.fragment, bits=cfg.bits) if cfg.fragment is not None
            else FormsSpec(bits=cfg.bits))
    draft_params, report = make_draft_tree(draft_params, spec, bits=cfg.bits, mode=cfg.mode)
    return draft_model, draft_params, report


# ---------------------------------------------------------------------------
# rejection-sampling math (the runner samples through these helpers)
# ---------------------------------------------------------------------------


def residual_distribution(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The resample distribution after a rejection, ``norm(max(p - q, 0))``;
    ``p`` where the residual mass is ~0 (p == q rejects with probability 0,
    so this only guards float noise)."""
    res = torch.clamp(p - q, min=0.0)
    tot = res.sum(-1, keepdim=True)
    return torch.where(tot > 1e-9, res / torch.clamp(tot, min=1e-20), p)


def rejection_outcome_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The closed-form distribution of one accept step: draw x ~ q, accept
    with probability min(1, p(x)/q(x)), else resample from
    :func:`residual_distribution`.  It equals ``p``."""
    accept = torch.minimum(p, q)
    rej = 1.0 - accept.sum(-1, keepdim=True)
    return accept + rej * residual_distribution(p, q)


def _accept(logits_t: torch.Tensor, draft_lg: torch.Tensor, drafts: torch.Tensor,
            k_eligible: torch.Tensor, temps: torch.Tensor, generator: torch.Generator
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot draft acceptance, on the device with no host sync.

    logits_t: (B, K+1, V) f32 target logits at positions pos..pos+K;
    draft_lg: (K, B, V) the logits each draft token was sampled from;
    drafts: (K, B) the draft tokens; k_eligible: (B,) each slot's draft
    budget this round; temps: (B,).  Greedy rows (temp <= 0) accept d_i iff
    it is the target argmax and correct with the argmax; temperature rows
    accept d_i with probability min(1, p_i(d)/q_i(d)) and correct from the
    residual (drawn by Gumbel-max with ``generator``); a fully accepted row
    takes its bonus token from the K+1-th logits.  Returns (out (B, K+1)
    emitted-token grid, n_emit (B,)).
    """
    kk, b = drafts.shape
    dev = logits_t.device
    drafts_bt = drafts.T                                     # (B, K)
    lg_d = draft_lg.transpose(0, 1)                          # (B, K, V)
    greedy = temps <= 0.0
    safe_t = torch.clamp(temps, min=1e-6)
    t_arg = torch.argmax(logits_t, dim=-1).to(torch.int32)  # (B, K+1)

    acc_greedy = t_arg[:, :kk] == drafts_bt
    p = torch.softmax(logits_t[:, :kk] / safe_t[:, None, None], dim=-1)
    q = torch.softmax(lg_d / safe_t[:, None, None], dim=-1)
    idx_d = drafts_bt.long()[..., None]
    p_d = torch.gather(p, -1, idx_d)[..., 0]
    q_d = torch.gather(q, -1, idx_d)[..., 0]
    u = torch.rand((b, kk), generator=generator, device=dev)
    acc_temp = u * q_d < p_d          # u < p/q, with the q > 0 guard folded in

    accept = torch.where(greedy[:, None], acc_greedy, acc_temp)
    accept = accept & (torch.arange(kk, device=dev)[None, :] < k_eligible[:, None])
    # leading-accept count: the running product zeroes all after a reject
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)

    bidx = torch.arange(b, device=dev)
    p_j = torch.softmax(logits_t[bidx, n_acc] / safe_t[:, None], dim=-1)   # (B, V)
    # q at the correction index; zero past the eligible drafts, so the
    # residual is p there (the bonus token samples the whole target)
    q_j = torch.where((n_acc < k_eligible)[:, None],
                      q[bidx, torch.clamp(n_acc, max=kk - 1)], 0.0)
    res = residual_distribution(p_j, q_j)
    corr_temp = gumbel_argmax(torch.log(torch.clamp(res, min=1e-20)), generator)
    corr = torch.where(greedy, t_arg[bidx, n_acc], corr_temp)

    idx = torch.arange(kk + 1, device=dev)[None, :]
    drafts_pad = torch.cat([drafts_bt, torch.zeros((b, 1), dtype=torch.int32, device=dev)],
                           dim=1)
    out = torch.where(idx < n_acc[:, None], drafts_pad, corr[:, None])
    return out, (n_acc + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotSpecState:
    """Host-side adaptive-K state of one serving slot."""

    k: int
    ewma: float = 1.0


class SpeculativeRunner(ModelRunner):
    """A :class:`ModelRunner` whose decode round is draft K, verify once.

    The target side is the plain runner (prefill buckets, sampling).  A
    round (:meth:`speculate_round`) runs on the device: ``kk + 1`` draft
    ``decode_paged`` calls on the draft's page pool (same block tables),
    one target ``decode_paged`` over the ``(B, kk + 1)`` tokens, which
    writes their K/V rows, and :func:`_accept`.  :meth:`decode_round` reads
    the emitted grid and the counts in one host read.  The round's width
    ``kk`` is the largest eligible K over the active slots, so a cold draft
    really runs fewer draft calls and verify columns; each round's width is
    kept in ``round_widths``.  Admission prefills both pools.
    """

    def __init__(self, model: Model, params: Any, cache: KV.PagedKVCache, *,
                 draft_model: Model, draft_params: Any, draft_cache: KV.PagedKVCache,
                 spec_cfg: SpeculateConfig, **kw):
        super().__init__(model, params, cache, **kw)
        if not self.paged:
            raise ValueError("speculative decoding verifies on the paged cache "
                             "(page_size=...)")
        self.draft_model = draft_model
        self.draft_params = draft_model.serving_params(draft_params)
        self.draft_cache = draft_cache
        self.spec_cfg = spec_cfg
        self.k_max = spec_cfg.k
        self._slots: Dict[int, SlotSpecState] = {}
        self.rounds = 0
        self.participations = 0   # active-slot round participations
        self.drafted = 0
        self.accepted = 0
        self.emitted = 0
        self.round_widths: List[int] = []

    @torch.inference_mode()
    def speculate_round(self, kk: int, tok: torch.Tensor, pos: torch.Tensor,
                        tables: torch.Tensor, k_eligible: torch.Tensor,
                        temps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device part of one round at width ``kk`` on device tensors:
        returns the (B, kk+1) emitted grid and the (B,) counts, unread."""
        with default_spec(self.spec), sparsity_stats(self.meter):
            drafts, draft_lg = [], []
            t, dpos = tok, pos
            # kk + 1 draft calls: the last one only writes the draft row of
            # d_kk, so a fully accepted round leaves the pools in step
            for i in range(kk + 1):
                logits, self.draft_cache = self.draft_model.decode_paged(
                    self.draft_params, t[:, None], self.draft_cache, dpos, tables)
                if i == kk:
                    break
                lg = logits[:, 0].float()
                t = sample_on_device(lg, temps, self.generator)
                drafts.append(t)
                draft_lg.append(lg)
                dpos = dpos + 1
            ver_in = torch.stack([tok] + drafts, dim=1)                 # (B, kk+1)
            logits_t, self.cache = self.model.decode_paged(self.params, ver_in,
                                                           self.cache, pos, tables)
            return _accept(logits_t.float(), torch.stack(draft_lg), torch.stack(drafts),
                           k_eligible, temps, self.generator)

    def reset_slot(self, slot: int) -> None:
        """Fresh adaptive-K state for a newly admitted request."""
        self._slots.pop(slot, None)

    def _slot_state(self, slot: int) -> SlotSpecState:
        st = self._slots.get(slot)
        if st is None:
            st = self._slots[slot] = SlotSpecState(k=self.k_max)
        return st

    def decode_round(self, tokens: np.ndarray, positions: np.ndarray,
                     temps: np.ndarray, block_tables: Optional[np.ndarray] = None,
                     active: Optional[List[bool]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round for all slots: ``(grid, counts)``, the
        (kk+1, slots) emitted grid and each slot's valid rows (1 + accepted
        drafts), from one host read.  ``kk`` is the largest eligible K of
        the active slots."""
        if block_tables is None:
            raise ValueError("speculative decode needs block_tables")
        b = len(tokens)
        act = [True] * b if active is None else list(active)
        k_eligible = np.asarray([self._slot_state(s).k if act[s] else 1 for s in range(b)],
                                np.int32)
        kk = max((int(k_eligible[s]) for s in range(b) if act[s]), default=self.k_max)
        out, n_emit = self.speculate_round(
            kk, self._to_device(tokens), self._to_device(positions),
            self._to_device(block_tables), self._to_device(k_eligible),
            self._to_device(temps, torch.float32))
        host = torch.cat([out, n_emit[:, None]], dim=1).cpu().numpy()
        out, counts = host[:, :-1], host[:, -1]
        self.rounds += 1
        self.round_widths.append(kk)
        cfg = self.spec_cfg
        for s in range(b):
            if not act[s]:
                continue
            st = self._slot_state(s)
            acc = int(counts[s]) - 1
            # verification yield: a finishing request's budget may take
            # fewer than counts[s] of the last round (scheduler's count)
            self.participations += 1
            self.drafted += int(k_eligible[s])
            self.accepted += acc
            self.emitted += int(counts[s])
            if cfg.adaptive:
                st.ewma = (1 - cfg.ewma) * st.ewma + cfg.ewma * acc / max(1, int(k_eligible[s]))
                if st.ewma < cfg.low:
                    st.k = max(cfg.k_min, st.k - 1)
                elif st.ewma > cfg.high:
                    st.k = min(self.k_max, st.k + 1)
        return out.T, counts

    @torch.inference_mode()
    def prefill_slot(self, slot: int, prompt: np.ndarray, temperature: float = 0.0,
                     pages: Optional[np.ndarray] = None) -> int:
        """Admit into both pools: the target prefill samples the first token,
        then the draft prefill writes the draft pool's rows of the same
        pages (scratch-0 entries protect prefix-shared pages in both)."""
        tok = super().prefill_slot(slot, prompt, temperature, pages=pages)
        toks, n = self.padded_prompt(prompt)
        _, self.draft_cache = self._prefill_call(self.draft_model, self.draft_params,
                                                 self.draft_cache, self._to_device(toks),
                                                 slot, n, pages)
        return tok

    @torch.inference_mode()
    def prefill_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                      block_tables: np.ndarray, cols: np.ndarray,
                      temps: np.ndarray) -> np.ndarray:
        """Chunked admission into both pools: after the target's chunk, one
        draft ``decode_paged`` writes the same rows into the draft pool
        (same tokens, positions and tables), so a request that finishes
        chunked prefill enters the speculative rounds position-synced, as
        after bulk admission."""
        tok = super().prefill_chunk(tokens, positions, block_tables, cols, temps)
        with default_spec(self.spec):
            _, self.draft_cache = self.draft_model.decode_paged(
                self.draft_params, self._to_device(tokens), self.draft_cache,
                self._to_device(positions), self._to_device(block_tables))
        return tok

    def spec_stats(self) -> Dict[str, Any]:
        """Lifetime counters: ``acceptance`` is accepted over eligible
        drafts; ``tokens_per_round`` is per slot-round (1 + accepted drafts,
        in [1, k+1]), verification yield before any budget truncation;
        ``slot_k`` lists the slots that have held a request."""
        return {
            "rounds": self.rounds,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "acceptance": self.accepted / max(1, self.drafted),
            "tokens_per_round": self.emitted / max(1, self.participations),
            "slot_k": {s: st.k for s, st in sorted(self._slots.items())},
        }
