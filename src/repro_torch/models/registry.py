"""Model registry: family dispatch (counterpart of ``repro.models.registry``).

Every family of the reference: ``dense`` and ``vlm``
(``models/transformer.py``), ``moe`` (``models/moe.py``, with MLA attention
from ``models/mla.py``), ``encdec`` (``models/encdec.py``), ``ssm``
(``models/xlstm.py``) and ``hybrid`` (``models/hybrid.py``). The
reference's abstract ``input_specs`` (its dry run's stand-ins) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, moe, transformer, xlstm

_FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe, "encdec": encdec,
             "ssm": xlstm, "hybrid": hybrid}


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    specs: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache_specs: Callable
    # dotted paths of the parameters the loss does not reach (zero gradients)
    idle_params: tuple[str, ...] = ()


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not one of the reference's "
                                  f"{sorted(_FAMILIES)}")
    mod = _FAMILIES[cfg.family]
    return ModelAPI(
        cfg=cfg,
        specs=lambda: mod.specs(cfg),
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        prefill=lambda p, b: mod.prefill(p, b, cfg),
        decode_step=lambda p, c, t, pos: mod.decode_step(p, c, t, pos, cfg),
        init_cache_specs=lambda batch, seq: mod.init_cache_specs(cfg, batch, seq),
        idle_params=mod.idle_params(cfg) if hasattr(mod, "idle_params") else (),
    )
