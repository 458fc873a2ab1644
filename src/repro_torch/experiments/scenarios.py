"""Synthetic scenario library (DESIGN.md §7.2).

Five workload families beyond the classic FIO-style distributions, each
chosen to stress a different part of the conversion policy:

  hotspot_shift         — the hot set *moves*: conversions made for the old
                          hotspot become stale capacity loss (reclaim test).
  bursty                — on/off traffic: intense bursts on a small hot set
                          separated by sparse background reads (heat decay).
  diurnal               — skew oscillates like day/night phases: popularity
                          concentrates and disperses smoothly.
  write_burst_then_read — a bulk ingest then a read-mostly phase: fresh
                          pages have low retention error, so early
                          conversions are wasteful (retry-awareness test).
  read_disturb_hammer   — a tiny LPN range is hammered so its blocks' read
                          counts explode: the paper's core motivation, where
                          disturb-driven retries ruin tail latency and
                          retry-aware migration pays off most.

All generators are host-side numpy (like ``ssdsim.workload``), fully
deterministic under a fixed seed, and return engine-ready packed traces.
Counterpart of ``repro.experiments.scenarios``: the same seed gives the
same trace, bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.experiments.registry import register
from repro_torch.ssdsim import geometry, workload
from repro_torch.ssdsim.engine import OP_READ, OP_WRITE


@register("hotspot_shift")
def hotspot_shift(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                  n_phases: int = 4, hot_frac: float = 0.05,
                  hot_prob: float = 0.9):
    """Reads with a contiguous hotspot that jumps to a new region each phase.

    Within a phase, ``hot_prob`` of requests land uniformly in the current
    hotspot (``hot_frac`` of the logical space); the rest are uniform over
    the whole device.
    """
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    hot_n = max(int(L * hot_frac), 1)
    per_phase = -(-n_requests // n_phases)
    lpn = np.empty(n_requests, np.int64)
    for ph in range(n_phases):
        lo, hi = ph * per_phase, min((ph + 1) * per_phase, n_requests)
        if lo >= hi:
            break
        start = (ph * (L // n_phases)) % max(L - hot_n, 1)
        n = hi - lo
        is_hot = rng.random(n) < hot_prob
        seg = np.where(
            is_hot,
            start + rng.integers(0, hot_n, size=n),
            rng.integers(0, L, size=n),
        )
        lpn[lo:hi] = seg
    return workload._pack(cfg, lpn.astype(np.int32), np.full(n_requests, OP_READ, np.int32))


@register("bursty")
def bursty(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
           burst_len: int = 2048, idle_len: int = 2048,
           hot_frac: float = 0.02, theta: float = 1.2):
    """On/off traffic: Zipf bursts over a small hot set, then sparse uniform
    background reads while the burst set cools (exercises heat decay and the
    reclaim hysteresis)."""
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    hot_n = max(int(L * hot_frac), 1)
    hot_set = rng.permutation(L)[:hot_n]
    p = workload.zipf_probs(hot_n, theta)
    lpn = np.empty(n_requests, np.int64)
    i, on = 0, True
    while i < n_requests:
        n = min(burst_len if on else idle_len, n_requests - i)
        if on:
            lpn[i:i + n] = hot_set[rng.choice(hot_n, size=n, p=p)]
        else:
            lpn[i:i + n] = rng.integers(0, L, size=n)
        i += n
        on = not on
    return workload._pack(cfg, lpn.astype(np.int32), np.full(n_requests, OP_READ, np.int32))


@register("diurnal")
def diurnal(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
            n_cycles: int = 2, n_segments: int = 32,
            theta_lo: float = 0.6, theta_hi: float = 1.4):
    """Skew oscillates sinusoidally between ``theta_lo`` (dispersed,
    night-time scans) and ``theta_hi`` (concentrated, day-time serving)
    across ``n_cycles`` day/night phases."""
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    perm = rng.permutation(L)
    per_seg = -(-n_requests // n_segments)
    lpn = np.empty(n_requests, np.int64)
    for seg in range(n_segments):
        lo, hi = seg * per_seg, min((seg + 1) * per_seg, n_requests)
        if lo >= hi:
            break
        phase = 2.0 * np.pi * n_cycles * seg / n_segments
        theta = theta_lo + (theta_hi - theta_lo) * 0.5 * (1.0 + np.sin(phase))
        p = workload.zipf_probs(L, theta)
        lpn[lo:hi] = perm[rng.choice(L, size=hi - lo, p=p)]
    return workload._pack(cfg, lpn.astype(np.int32), np.full(n_requests, OP_READ, np.int32))


@register("write_burst_then_read")
def write_burst_then_read(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                          write_frac: float = 0.3, theta: float = 1.2):
    """Bulk ingest then read-mostly serving: the first ``write_frac`` of the
    trace uniformly overwrites pages, the remainder Zipf-reads the device.
    Freshly rewritten pages have near-zero retention/disturb error, so a
    retry-aware policy should convert far less than a temperature-only one.
    """
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    n_w = int(n_requests * write_frac)
    w_lpn = rng.integers(0, L, size=n_w)
    p = workload.zipf_probs(L, theta)
    perm = rng.permutation(L)
    r_lpn = perm[rng.choice(L, size=n_requests - n_w, p=p)]
    lpn = np.concatenate([w_lpn, r_lpn]).astype(np.int32)
    op = np.concatenate([
        np.full(n_w, OP_WRITE, np.int32),
        np.full(n_requests - n_w, OP_READ, np.int32),
    ])
    return workload._pack(cfg, lpn, op)


@register("fault_storm")
def fault_storm(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                theta: float = 1.2, read_frac: float = 0.3,
                write_theta: float = 2.0):
    """Write-heavy Zipf overwrites plus skewed re-reads: the workload shape
    under which every injected fault class (DESIGN.md §2D) actually fires.
    Concentrated overwrites manufacture GC victims, so erases happen at a
    steady rate (erase failures -> bad-block retirement), the write stream
    exercises program failures and the re-placement path, and the hot read
    set keeps hammering aged pages (uncorrectable reads once a retry budget
    is set). The elevated P/E cycles and the fault rates themselves ride on
    the config / sweep fault axes — pair this trace with
    ``configs.raro_ssd.fault_storm_sweep``."""
    return workload.mixed_trace(cfg, n_requests, theta, read_frac=read_frac,
                                seed=seed, write_theta=write_theta)


@register("zipf_openloop")
def zipf_openloop(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                  theta: float = 1.2, rate_iops: float = 50_000.0,
                  arrival_dist: str = "poisson"):
    """Zipf reads with open-loop Poisson (or constant-rate) arrivals at
    ``rate_iops``. The base scenario for latency-vs-offered-load curves:
    sweep the offered load via ``RunKnobs.arrival_scale`` (a per-run rate
    multiplier) so every load point shares one trace."""
    tr = workload.zipf_read_trace(cfg, n_requests, theta, seed=seed)
    return workload.attach_arrivals(cfg, tr, rate_iops, dist=arrival_dist,
                                    seed=seed + 1)


@register("hammer_openloop")
def hammer_openloop(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                    hammer_pages: int | None = None, hammer_prob: float = 0.8,
                    rate_iops: float = 50_000.0,
                    arrival_dist: str = "poisson"):
    """Read-disturb hammer with open-loop arrivals — the paper's tail-latency
    story under real queueing: disturb-driven retries inflate service times,
    which inflate queueing delay on the hammered LUNs, which is exactly the
    effect the closed-loop engine cannot show."""
    tr = read_disturb_hammer(cfg, n_requests, seed=seed,
                             hammer_pages=hammer_pages,
                             hammer_prob=hammer_prob)
    return workload.attach_arrivals(cfg, tr, rate_iops, dist=arrival_dist,
                                    seed=seed + 1)


@register("read_disturb_hammer")
def read_disturb_hammer(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
                        hammer_pages: int | None = None,
                        hammer_prob: float = 0.8):
    """Hammer a tiny contiguous LPN range (a few physical blocks under the
    sequential pre-fill) so those blocks' read counts — and hence their
    disturb-driven retry counts — explode, while background reads stay
    uniform. The scenario where retry-aware SLC promotion matters most for
    p99: a baseline device keeps re-reading ever-slower QLC pages.
    """
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    if hammer_pages is None:
        hammer_pages = max(2 * cfg.slots_per_block, 1)  # ~2 QLC blocks
    hammer_pages = min(hammer_pages, L)
    start = int(rng.integers(0, max(L - hammer_pages, 1)))
    n = n_requests
    is_hammer = rng.random(n) < hammer_prob
    lpn = np.where(
        is_hammer,
        start + rng.integers(0, hammer_pages, size=n),
        rng.integers(0, L, size=n),
    )
    return workload._pack(cfg, lpn.astype(np.int32), np.full(n, OP_READ, np.int32))
