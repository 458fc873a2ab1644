"""Per-chunk policy evaluation for the three schemes (paper §V-A):

  BASELINE — multi-read-retry QLC, no mode awareness: never migrates.
  HOTNESS  — temperature-only SLC-TLC-QLC conversion (comparison scheme).
  RARO     — temperature AND Eq.-3 retry thresholds (Table II).

Counterpart of ``repro.ssdsim.policies``: the policies see the pages read in
a chunk and emit -1-padded lpn lists per target mode for
``ftl.migrate_pages``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import ops
from repro_torch.core import hotness, modes, policy
from repro_torch.ssdsim import geometry


class RunKnobs(NamedTuple):
    """Per-run overrides of the SimConfig fields that never change shapes
    (numbers or 0-dim tensors). ``None`` fields fall back to the config:
    ``arrival_scale`` multiplies the offered rate of an open-loop trace; the
    four fault fields ``prog_fail_rate``, ``erase_fail_rate``,
    ``max_read_retries`` and ``fault_seed`` arm faults together (see
    ``faults.params_for``), with ``read_fail_rate``, ``fault_wear_slope``,
    ``parity_rebuild`` and ``spare_blocks`` riding on them; ``gc_objective``
    is a ``reclaim.GC_OBJECTIVE_CODES`` code."""

    r1: int | torch.Tensor
    r2_override: int | torch.Tensor  # < 0: use the paper's stage schedule
    initial_pe: int | torch.Tensor
    arrival_scale: float | torch.Tensor | None = None
    prog_fail_rate: float | torch.Tensor | None = None
    erase_fail_rate: float | torch.Tensor | None = None
    max_read_retries: int | torch.Tensor | None = None
    fault_seed: int | torch.Tensor | None = None
    read_fail_rate: float | torch.Tensor | None = None
    fault_wear_slope: float | torch.Tensor | None = None
    parity_rebuild: int | torch.Tensor | None = None
    spare_blocks: int | torch.Tensor | None = None
    gc_objective: int | torch.Tensor | None = None


def thresholds_for(cfg: geometry.SimConfig, pe_cycles, knobs: RunKnobs | None = None):
    if knobs is not None:
        # r2 resolved per element, so an explicit R2 and the stage schedule mix
        stage_th = policy.stage_thresholds(pe_cycles)
        r2o = ops.scalar(knobs.r2_override, torch.int32, pe_cycles.device)
        r2 = torch.where(r2o >= 0, r2o, stage_th.r2)
        return policy.Thresholds(knobs.r1, r2)
    if cfg.r2_override >= 0:
        return policy.Thresholds(cfg.r1, cfg.r2_override)
    return policy.stage_thresholds(pe_cycles, r1=cfg.r1)


def select_migrations(cfg: geometry.SimConfig, uniq_lpns, page_mode, page_retries,
                      page_heat, page_ok, pe_cycles, knobs: RunKnobs | None = None):
    """Up to M pages per target mode to migrate this chunk: {mode: (M,) int32
    lpns, -1-padded}, hottest first (ties to the lower lane)."""
    M = cfg.migrate_pages_per_chunk
    cls = hotness.classify(page_heat, cfg.heat)

    if cfg.policy == geometry.RARO:
        th = thresholds_for(cfg, pe_cycles, knobs)
        target = policy.migration_decision(page_mode, cls, page_retries, th)
    elif cfg.policy == geometry.HOTNESS:
        target = policy.hotness_only_decision(page_mode, cls)
    else:  # BASELINE
        target = page_mode

    out = {}
    for tgt in (modes.SLC, modes.TLC):
        trig = page_ok & (target == tgt) & (page_mode != tgt) & (page_mode > tgt)
        score = torch.where(trig, page_heat, -torch.inf)
        k = min(M, score.shape[0])
        v, i = ops.top_k(score, k)
        sel = torch.where(v > -torch.inf, uniq_lpns[i.long()], -1).to(torch.int32)
        if k < M:
            sel = torch.nn.functional.pad(sel, (0, M - k), value=-1)
        out[tgt] = sel
    return out
