"""RARO tier controller for the paged KV cache (counterpart of
``repro.kvcache.tiers``).

Drives the same policy code as the flash simulator (core.policy Table II,
core.hotness, core.retry Eq. 3), with the Layer-B variable mapping of
DESIGN.md §2B:

  flash mode       -> KV tier            (ids shared, core.modes)
  P/E cycles       -> requantization events per page
  retention time   -> page age in decode steps
  read disturbs    -> accumulated attention mass ("reads")
  RBER             -> relative dequant error of the tier
  read retry count -> Eq.-3 correction-cost estimate from that error

Elastic capacity recovery demotes cold pages under pool pressure (Fig. 12).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import hotness, modes, policy, retry
from repro_torch.kernels.quant_page.ops import quant_store_pages
from repro_torch.kernels.quant_page.ref import scatter_drop
from repro_torch.kvcache import paged


@dataclass(frozen=True)
class RAROConfig:
    heat: hotness.HeatConfig = field(
        default_factory=lambda: hotness.HeatConfig(decay=0.95, hot_thresh=0.08, warm_thresh=0.02)
    )
    r1: int = 1
    r2: int = 5
    # Layer-B stress scaling onto the Eq.-1 input ranges of the flash constants.
    cycles_per_requant: float = 120.0
    hours_per_step: float = 0.05
    reads_scale: float = 40.0
    enabled: bool = True  # False -> static tiers (baseline)


def page_retry_estimate(c: paged.TieredKV, rcfg: RAROConfig):
    """Eq.(1) -> Eq.(3) per logical page, using its tier as the mode."""
    tier = torch.clamp(c.tier, min=modes.SLC)
    cycles = c.requants.float() * rcfg.cycles_per_requant
    age_h = (c.step - c.born).float() * rcfg.hours_per_step
    reads = c.reads * rcfg.reads_scale
    page_ids = torch.arange(c.tier.numel(), dtype=torch.int32,
                            device=c.tier.device).reshape(c.tier.shape)
    n = retry.page_retries(tier, cycles, age_h, reads, page_ids)
    return torch.where(c.tier >= 0, n, 0)


def update_stats(c: paged.TieredKV, masses, rcfg: RAROConfig):
    """Fold one decode step's per-page attention masses (B, MaxP) into the
    hotness/reads metadata."""
    hot = hotness.decay_heat(c.hot, rcfg.heat) + masses
    return c._replace(hot=hot, reads=c.reads + masses)


def commit_tier(c: paged.TieredKV, cfg: paged.CacheConfig, rcfg: RAROConfig):
    """Write-path decision: tier for the page each sequence commits next,
    from the hotness of its most recent committed page."""
    if not rcfg.enabled:
        return torch.full((cfg.n_seqs,), modes.TIER_INT4, dtype=torch.int32,
                          device=c.tier.device)
    # clamped to the table, as the reference's gather clamps an out-of-range index
    last = torch.clamp(c.seq_len // cfg.page_size - 1, 0, cfg.max_pages - 1).long()
    bidx = torch.arange(cfg.n_seqs, device=c.tier.device)
    cls = hotness.classify(c.hot[bidx, last], rcfg.heat)
    out = torch.where(cls == modes.WARM, modes.TIER_INT8, modes.TIER_INT4)
    return torch.where(cls == modes.HOT, modes.TIER_BF16, out).to(torch.int32)


def _move_pages(c: paged.TieredKV, cfg: paged.CacheConfig, sel_b, sel_p, tgt: int):
    """Migrate up to M logical pages (sel_b/sel_p, -1-padded) to tier tgt.
    Returns (new cache, number moved)."""
    b_safe = torch.clamp(sel_b, min=0).long()
    p_safe = torch.clamp(sel_p, min=0).long()
    cur_tier = c.tier[b_safe, p_safe]
    cur_slot = c.slot[b_safe, p_safe]
    ok = (sel_b >= 0) & (cur_tier >= 0) & (cur_tier != tgt)

    kpage, vpage = paged._load_page(c, torch.where(ok, cur_tier, -1), cur_slot)

    free = list(c.free)
    slots, free[tgt] = paged._alloc(free[tgt], ok)
    moved = ok & (slots >= 0)

    pools = (c.k16, c.v16, c.k8, c.v8, c.sk8, c.sv8, c.k4, c.v4, c.sk4, c.sv4)
    if tgt == modes.TIER_BF16:  # a cast, no quantization: no kernel
        row = torch.where(moved, slots, c.k16.shape[0]).long()
        pools = (scatter_drop(c.k16, row, kpage.to(c.k16.dtype)),
                 scatter_drop(c.v16, row, vpage.to(c.v16.dtype)), *pools[2:])
    else:
        pools = quant_store_pages(kpage, vpage, torch.full_like(slots, tgt),
                                  torch.where(moved, slots, -1), pools, tiers=(tgt,))

    # release source slots (never in tier tgt: ok excludes it)
    for t in range(3):
        if t != tgt:
            rel = moved & (cur_tier == t)
            free[t] = scatter_drop(free[t], torch.where(rel, cur_slot, free[t].shape[0]).long(),
                                   True)

    # -1-padded lanes clamp to (0, 0), which a moved lane may also name: they
    # are dropped to a trailing entry of the flattened tables
    n_seqs, mp = c.tier.shape
    flat = torch.where(moved, b_safe * mp + p_safe, n_seqs * mp)

    def put(tab, val):
        return scatter_drop(tab.reshape(-1), flat, val).reshape(tab.shape)

    tier_tab, slot_tab = put(c.tier, tgt), put(c.slot, slots)
    requants = c.requants if tgt == modes.TIER_BF16 else put(c.requants,
                                                              c.requants[b_safe, p_safe] + 1)
    # conversion resets the page's stress clock (fresh program, Fig. 8)
    born, reads = put(c.born, c.step), put(c.reads, 0.0)

    (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4) = pools
    return c._replace(
        k16=k16, v16=v16, k8=k8, v8=v8, sk8=sk8, sv8=sv8, k4=k4, v4=v4,
        sk4=sk4, sv4=sv4, tier=tier_tab, slot=slot_tab, free=tuple(free),
        requants=requants, born=born, reads=reads,
    ), moved.sum()


def _topk_pages(score, m):
    """Top-m (b, p) indices of a (B, MaxP) score; -1 where score = -inf.
    Ties go to the lower flat index, as ``lax.top_k`` orders them: a stable
    descending sort, where ``torch.topk`` promises no order among ties."""
    _, mp = score.shape
    v, i = torch.sort(score.reshape(-1), descending=True, stable=True)
    v, i = v[:m], i[:m].to(torch.int32)
    ok = v > -torch.inf
    return torch.where(ok, i // mp, -1), torch.where(ok, i % mp, -1)


def raro_step(c: paged.TieredKV, cfg: paged.CacheConfig, rcfg: RAROConfig, masses):
    """One controller invocation between decode steps (paper Fig. 11):
    1. heat classifier   2. RBER/retry estimate   3. Table-II migration,
    plus elastic capacity recovery under pool pressure."""
    c = update_stats(c, masses, rcfg)
    if not rcfg.enabled:
        return c, {}

    retries = page_retry_estimate(c, rcfg)
    cls = hotness.classify(c.hot, rcfg.heat)
    th = policy.Thresholds(rcfg.r1, rcfg.r2)
    tier = torch.where(c.tier >= 0, c.tier, modes.SLC)  # invalid pages -> SLC (never migrate)
    target = policy.migration_decision(tier, cls, retries, th)
    target = torch.where(c.tier >= 0, target, c.tier)

    stats = {}
    m = cfg.migrate_per_step
    neg_inf = torch.full((), -torch.inf, dtype=c.hot.dtype, device=c.hot.device)
    for tgt in (modes.TIER_BF16, modes.TIER_INT8):
        trig = (c.tier >= 0) & (target == tgt) & (c.tier > tgt)
        sb, sp = _topk_pages(torch.where(trig, c.hot, neg_inf), m)
        c, n = _move_pages(c, cfg, sb, sp, tgt)
        stats[f"promoted_to_{modes.TIER_NAMES[tgt]}"] = n

    # elastic capacity recovery (Fig. 12): demote cold pages under pool
    # pressure, one density level at a time
    occ = paged.pool_occupancy(c)
    for src in (modes.TIER_BF16, modes.TIER_INT8):
        pressure = occ[src] > cfg.high_watermark
        cold = (c.tier == src) & (cls == modes.COLD)
        sb, sp = _topk_pages(torch.where(cold & pressure, -c.hot, neg_inf), m)
        c, n = _move_pages(c, cfg, sb, sp, src + 1)
        stats[f"demoted_from_{modes.TIER_NAMES[src]}"] = n
    return c, stats
