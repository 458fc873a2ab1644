"""Flash-mode translation controller (paper §IV-A/§IV-D).

Counterpart of ``repro.core.controller``. The per-*page* Table-II decisions
are aggregated to per-*block* conversion plans ("flash type alignment": the
block is the smallest management unit). A block converts to the
lowest-density (fastest) target requested by any of its triggering pages;
untouched blocks keep their mode.
"""

from __future__ import annotations

import torch

from repro_torch import ops
from repro_torch.core import hotness, modes, policy, retry


def block_conversion_plan(page_target, page_mode, page_block, page_valid, n_blocks,
                          block_mode):
    """Aggregate page-level targets ((P,) each) into (B,) int32 target block
    modes (``block_mode`` where nothing triggers)."""
    triggered = (page_target != page_mode) & page_valid
    # min over triggering pages per block; N_MODES (out of range) = no trigger
    req = torch.where(triggered, page_target.to(torch.int32), modes.N_MODES).to(torch.int32)
    per_block = ops.segment_min(req, page_block, n_blocks)
    return torch.where(per_block < modes.N_MODES, per_block, block_mode).to(torch.int32)


def raro_page_decision(page_mode, page_heat, page_pe_cycles, page_time_h, page_reads,
                       page_ids, heat_cfg: hotness.HeatConfig, r1: int = policy.DEFAULT_R1):
    """Full RARO per-page pipeline (paper Fig. 11): heat classifier, then
    RBER and retry estimate (Eq. 1 -> Eq. 3), then the Table-II decision with
    stage-adaptive thresholds. Returns (targets, retries, heat classes)."""
    heat_cls = hotness.classify(page_heat, heat_cfg)
    retries = retry.page_retries(page_mode, page_pe_cycles, page_time_h, page_reads, page_ids)
    th = policy.stage_thresholds(page_pe_cycles, r1=r1)
    return policy.migration_decision(page_mode, heat_cls, retries, th), retries, heat_cls


def hotness_page_decision(page_mode, page_heat, heat_cfg: hotness.HeatConfig):
    """'Hotness' comparison scheme: temperature-only decision."""
    heat_cls = hotness.classify(page_heat, heat_cfg)
    return policy.hotness_only_decision(page_mode, heat_cls), heat_cls
