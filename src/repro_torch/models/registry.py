"""Model registry: family dispatch (counterpart of ``repro.models.registry``).

Only the dense family is ported; the others are in ROADMAP.md, queue 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES = {"dense": transformer}


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    specs: Callable
    decode_step: Callable


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1)")
    mod = _FAMILIES[cfg.family]
    return ModelAPI(
        cfg=cfg,
        specs=lambda: mod.specs(cfg),
        decode_step=lambda p, c, t, pos: mod.decode_step(p, c, t, pos, cfg),
    )
