"""Model registry: family dispatch and the abstract input specs of each
shape cell (counterpart of ``repro.models.registry``).

Every family of the reference: ``dense`` and ``vlm``
(``models/transformer.py``), ``moe`` (``models/moe.py``, with MLA attention
from ``models/mla.py``), ``encdec`` (``models/encdec.py``), ``ssm``
(``models/xlstm.py``) and ``hybrid`` (``models/hybrid.py``). The
reference's abstract ``input_specs`` (its dry run's stand-ins) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import base, encdec, hybrid, moe, transformer, xlstm

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for every model input of this cell: the shapes
    and dtypes of the real inputs, no allocation (the dry run's contract)."""
    i32 = torch.int32
    gb, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        n_txt = s - cfg.n_img_tokens if cfg.family == "vlm" else s
        batch = {"tokens": meta((gb, n_txt), i32)}
        if shape.kind == "train":
            batch["labels"] = meta((gb, n_txt), i32)
        if cfg.family == "encdec":
            batch["frames"] = meta((gb, cfg.enc_len, cfg.d_model), cfg.dtype)
        if cfg.family == "vlm":
            batch["img_embeds"] = meta((gb, cfg.n_img_tokens, cfg.d_model), cfg.dtype)
        return batch

    # decode: one new token against a seq_len-deep cache
    return {"tokens": meta((gb, 1), i32), "pos": meta((gb,), i32),
            "cache": base.abstract(get_api(cfg).init_cache_specs(gb, s))}
