"""Arch registry: config -> a uniform :class:`Model` bundle.

The port serves the dense transformer family so far; every other family
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer

Params = Any


@dataclasses.dataclass(frozen=True)
class Model:
    """The functions the serving engine consumes, bound to one config and
    one device.

    ``init(seed)`` makes random params on the device; ``forward(params,
    batch, remat=, return_hidden=)`` is the full-sequence pass training
    takes; ``head_matrix(params)`` the LM head training reads (the tied
    ``embed.T``, never the serving copy); ``prefill_paged(params,
    tokens (1, S), cache, pages, slot, length)`` returns the logits (1, V) at
    ``length - 1`` and writes the prompt's pages; ``decode_paged(params,
    tokens (B, T), cache, pos (B,), block_tables)`` returns (B, T, V) logits
    and commits the new tokens.
    """

    config: ModelConfig
    device: torch.device
    init: Callable[..., Params]
    forward: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    head_matrix: Callable[[Params], Any]
    init_paged_cache: Callable[..., Any]
    prefill_paged: Callable[..., Tuple[torch.Tensor, Any]]
    decode_paged: Callable[..., Tuple[torch.Tensor, Any]]
    serving_params: Callable[[Params], Params]


_NOT_PORTED = {
    "moe": "ROADMAP queue 1, item 10 (other families: models/moe.py)",
    "whisper": "ROADMAP queue 1, item 10 (other families: models/whisper.py)",
    "xlstm": "ROADMAP queue 1, item 10 (other families: models/xlstm.py)",
    "zamba": "ROADMAP queue 1, item 10 (other families: models/zamba.py)",
}


def build(cfg: ModelConfig, device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> Model:
    """Bind the family of ``cfg`` to ``device`` (default ``"cuda"``; raises
    when CUDA is absent unless the caller asks for ``"cpu"``)."""
    if cfg.family != "dense":
        why = _NOT_PORTED.get(cfg.family, "no port planned")
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: {why}")
    if cfg.num_image_tokens:
        raise NotImplementedError(
            "the VLM patch-embedding prefix is not ported yet (ROADMAP queue 1, "
            "item 10)")
    dev = resolve_device(device)
    mod = transformer

    def init(seed: int = 0, generator: Optional[torch.Generator] = None) -> Params:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        return mod.init(cfg, generator)

    return Model(
        config=cfg,
        device=dev,
        init=init,
        forward=lambda params, batch, **kw: mod.forward(cfg, params, batch, **kw),
        head_matrix=lambda params: mod.head_matrix(cfg, params),
        init_paged_cache=lambda num_pages, page_size, dtype=torch.bfloat16:
            mod.init_paged_cache(cfg, num_pages, page_size, dev, dtype),
        prefill_paged=lambda params, tokens, cache, pages, slot, length:
            mod.prefill_paged(cfg, params, tokens, cache, pages, slot, length),
        decode_paged=lambda params, tokens, cache, pos, block_tables:
            mod.decode_paged(cfg, params, tokens, cache, pos, block_tables),
        serving_params=lambda params: mod.with_head_cast(cfg, params),
    )
