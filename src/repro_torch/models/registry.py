"""Model registry: family dispatch (counterpart of ``repro.models.registry``).

Ported: ``dense`` and ``vlm`` (``models/transformer.py``) and ``moe``
(``models/moe.py``, with MLA attention from ``models/mla.py``). ``encdec``,
``ssm`` and ``hybrid`` are in ROADMAP.md, queue 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe, transformer

_FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe}


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    specs: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache_specs: Callable


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1)")
    mod = _FAMILIES[cfg.family]
    return ModelAPI(
        cfg=cfg,
        specs=lambda: mod.specs(cfg),
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        prefill=lambda p, b: mod.prefill(p, b, cfg),
        decode_step=lambda p, c, t, pos: mod.decode_step(p, c, t, pos, cfg),
        init_cache_specs=lambda batch, seq: mod.init_cache_specs(cfg, batch, seq),
    )
