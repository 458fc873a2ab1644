"""Heat classifier (paper §IV-A) — exponential-decay access-frequency counters.

Counterpart of ``repro.core.hotness`` (the parts the KV-cache tier manager
uses: ``HeatConfig``, ``decay_heat``, ``classify``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import modes


class HeatConfig(NamedTuple):
    """Decay + classification thresholds (one decay per epoch)."""

    decay: float = 0.95
    hot_thresh: float = 2.0
    warm_thresh: float = 0.5


def decay_heat(heat, cfg: HeatConfig):
    return heat * cfg.decay


def classify(heat, cfg: HeatConfig):
    """Counter values -> {COLD, WARM, HOT} labels (int32).

    The thresholds are compared in float32, as the reference compares a
    float32 array against a weakly typed Python float. They are filled on
    the heat's device, where a host tensor would be a copy the host waits on.
    """
    hot = torch.full((), cfg.hot_thresh, dtype=heat.dtype, device=heat.device)
    warm = torch.full((), cfg.warm_thresh, dtype=heat.dtype, device=heat.device)
    out = torch.where(heat >= warm, modes.WARM, modes.COLD)
    return torch.where(heat >= hot, modes.HOT, out).to(torch.int32)
