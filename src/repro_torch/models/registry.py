"""Arch registry: config -> a uniform :class:`Model` bundle.

The port serves every family of the JAX package: the dense transformer,
the MoE family (GQA/MHA attention as in olmoe, MLA with multi-token
prediction as in deepseek-v3), whisper's encoder-decoder, and the
recurrent families xlstm (sLSTM + mLSTM) and zamba (Mamba2 + shared
attention), whose O(1) decode state has no paged path: their
``init_paged_cache``/``prefill_paged``/``decode_paged`` are None, so the
engine serves them on the dense slot cache.  A VLM config
(``num_image_tokens``, as phi-3-vision) takes precomputed patch embeddings
before its tokens in ``forward``; serving is text-only, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import moe, transformer, whisper, xlstm, zamba

Params = Any


@dataclasses.dataclass(frozen=True)
class Model:
    """The functions the serving engine consumes, bound to one config and
    one device.

    ``init(seed)`` makes random params on the device; ``forward(params,
    batch, remat=, return_hidden=)`` is the full-sequence pass training
    takes; ``head_matrix(params)`` the LM head training reads (the tied
    ``embed.T``, never the serving copy).  Serving has two caches: the
    dense slot cache (``init_cache(batch, max_len)``; ``prefill(params,
    tokens (1, S), cache, slot, length)`` and ``decode_step(params, tokens
    (B, T), cache, pos (B,))``) and the paged one (``init_paged_cache(
    num_pages, page_size, slots, max_len)``, where ``slots``/``max_len``
    size the slot-addressed leaves beside the pool: whisper's encoder
    output;
    ``prefill_paged(params, tokens, cache, pages, slot, length)`` writes the
    prompt's pages, ``decode_paged(params, tokens, cache, pos,
    block_tables)`` commits the new tokens).  The prefills return the
    logits (1, V) at ``length - 1``, the decodes (B, T, V): T is 1 in plain
    decoding and K+1 in a speculative verify.  ``input_fields`` are the
    batch keys ``forward`` consumes; ``padded_prefill`` says whether a
    prompt may be padded to its bucket (False for MoE, whose capacity-based
    dispatch would give pad tokens expert capacity, and for the recurrent
    families, whose state consumes every token).  The recurrent families
    have no paged functions (None): ``supports_paged`` is False.
    ``make_inputs(generator, batch, seq)`` makes random inputs of every
    field (a VLM's ``seq`` counts its patch positions).
    """

    config: ModelConfig
    device: torch.device
    init: Callable[..., Params]
    forward: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    head_matrix: Callable[[Params], Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    init_paged_cache: Optional[Callable[..., Any]]
    prefill_paged: Optional[Callable[..., Tuple[torch.Tensor, Any]]]
    decode_paged: Optional[Callable[..., Tuple[torch.Tensor, Any]]]
    serving_params: Callable[[Params], Params]
    input_fields: Tuple[str, ...] = ("tokens",)
    padded_prefill: bool = True

    @property
    def supports_paged(self) -> bool:
        return (self.init_paged_cache is not None and self.prefill_paged is not None
                and self.decode_paged is not None)

    def make_inputs(self, generator: torch.Generator, batch: int, seq: int
                    ) -> Dict[str, torch.Tensor]:
        """Random inputs of every field on the model's device, drawn from
        ``generator`` (on that device; the reference's shapes, torch's
        draws): tokens (B, seq - num_image_tokens) int32 next to a VLM's
        patch embeddings (B, num_image_tokens, d_model) f32, whisper's
        frames (B, seq, d_model) f32."""
        cfg, dev = self.config, self.device
        n_img = cfg.num_image_tokens if "patch_embeds" in self.input_fields else 0
        out: Dict[str, torch.Tensor] = {}
        for f in self.input_fields:
            if f == "tokens":
                out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq - n_img),
                                              generator=generator, device=dev,
                                              dtype=torch.int32)
            elif f == "patch_embeds":
                out["patch_embeds"] = torch.randn((batch, n_img, cfg.d_model),
                                                  generator=generator, device=dev)
            elif f == "frames":
                out["frames"] = torch.randn((batch, seq, cfg.d_model), generator=generator,
                                            device=dev)
        return out


_FAMILIES = {"dense": transformer, "moe": moe, "whisper": whisper, "xlstm": xlstm,
             "zamba": zamba}


def build(cfg: ModelConfig, device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> Model:
    """Bind the family of ``cfg`` to ``device`` (default ``"cuda"``; raises
    when CUDA is absent unless the caller asks for ``"cpu"``)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not a family of the JAX "
                                  f"package (known: {sorted(_FAMILIES)})")
    dev = resolve_device(device)
    mod = _FAMILIES[cfg.family]

    def init(seed: int = 0, generator: Optional[torch.Generator] = None) -> Params:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        return mod.init(cfg, generator)

    # the recurrent families (O(1) state) have no paged path: None here,
    # and the engine falls back to the dense slot cache
    paged_kw: Dict[str, Any] = dict(init_paged_cache=None, prefill_paged=None,
                                    decode_paged=None)
    if hasattr(mod, "init_paged_cache"):
        paged_kw = dict(
            init_paged_cache=lambda num_pages, page_size, slots=1, max_len=None,
            dtype=torch.bfloat16: mod.init_paged_cache(cfg, num_pages, page_size, dev, dtype,
                                                       slots=slots, max_len=max_len),
            prefill_paged=lambda params, tokens, cache, pages, slot, length:
                mod.prefill_paged(cfg, params, tokens, cache, pages, slot, length),
            decode_paged=lambda params, tokens, cache, pos, block_tables:
                mod.decode_paged(cfg, params, tokens, cache, pos, block_tables))
    return Model(
        config=cfg,
        device=dev,
        init=init,
        forward=lambda params, batch, **kw: mod.forward(cfg, params, batch, **kw),
        head_matrix=lambda params: mod.head_matrix(cfg, params),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16:
            mod.init_cache(cfg, batch, max_len, dev, dtype),
        prefill=lambda params, tokens, cache, slot, length:
            mod.prefill(cfg, params, tokens, cache, slot, length),
        decode_step=lambda params, tokens, cache, pos:
            mod.decode_step(cfg, params, tokens, cache, pos),
        **paged_kw,
        serving_params=lambda params: mod.with_head_cast(cfg, params),
        input_fields=(("frames", "tokens") if cfg.family == "whisper" else
                      ("tokens", "patch_embeds") if cfg.num_image_tokens else ("tokens",)),
        # exact-length prefill: padded tokens would route through moe's
        # capacity-based dispatch and take expert capacity from real tokens,
        # and the recurrent state consumes every token
        padded_prefill=cfg.family not in ("xlstm", "zamba", "moe"),
    )
