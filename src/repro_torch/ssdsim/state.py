"""Simulator state: a flat NamedTuple of tensors, the leaves of the
reference's ``SSDState`` in the same order and dtypes (0-dim tensors for
its scalars).

Counterpart of ``repro.ssdsim.state``. Physical page addressing: slot =
block * slots_per_block + offset; a block programmed in TLC/SLC mode only
uses the first pages_per_block(mode) offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import ops, resolve_device
from repro_torch.core import modes
from repro_torch.ssdsim import geometry, obs, telemetry

FREE = 0
OPEN = 1
FULL = 2
# Retired: the block failed an erase and left service permanently
# (DESIGN.md §2D). Never FREE again, never allocated, zero capacity.
BAD = 3

# Pool size for cfg.spare_blocks < 0: an unbounded spare pool (int32 max).
SPARE_UNLIMITED = 2**31 - 1


class SSDState(NamedTuple):
    # mapping
    l2p: torch.Tensor  # (L,) int32 logical -> physical slot (-1 unmapped)
    p2l: torch.Tensor  # (S,) int32 physical slot -> logical (-1 invalid)
    page_write_ms: torch.Tensor  # (S,) float32 sim-clock time of program

    # per-block
    block_mode: torch.Tensor  # (B,) int32 SLC/TLC/QLC
    block_state: torch.Tensor  # (B,) int32 FREE/OPEN/FULL/BAD
    block_pe: torch.Tensor  # (B,) int32 P/E cycles
    block_reads: torch.Tensor  # (B,) int32 reads since program (disturb)
    block_next: torch.Tensor  # (B,) int32 next free offset
    block_valid: torch.Tensor  # (B,) int32 valid page count
    block_cold_age: torch.Tensor  # (B,) int32 epochs since any hot/warm access
    block_bad: torch.Tensor  # (B,) bool grown bad-block map

    bad_count: torch.Tensor  # int32 — retired blocks
    spare_total: torch.Tensor  # int32 — configured spare pool size
    spare_count: torch.Tensor  # int32 — spares remaining

    # heat (logical)
    heat: torch.Tensor  # (L,) float32

    # allocation cursors
    open_user: torch.Tensor  # (n_dies,) int32 open block per die (-1 none)
    open_mig: torch.Tensor  # (3,) int32 open migration block per mode (-1)

    # free-pool bookkeeping
    free_count: torch.Tensor  # int32 — exact number of FREE blocks
    free_hint: torch.Tensor  # (n_dies,) int32 — a (possibly stale) free block per die

    # timing — the (channel, die, plane) resource lattice (DESIGN.md §2C)
    clock_ms: torch.Tensor  # f32 — simulated time
    die_busy_ms: torch.Tensor  # (n_dies,) f32 — cumulative busy time
    chan_busy_ms: torch.Tensor  # (n_channels,) f32 — cumulative transfer time
    die_avail_ms: torch.Tensor  # (n_dies,) f32 — busy-until clock per die (open loop)
    chan_avail_ms: torch.Tensor  # (n_channels,) f32 — busy-until per channel (lattice)

    # telemetry
    lat_hist: torch.Tensor  # (N_LAT_BINS,) f32 read-latency histogram
    w_lat_hist: torch.Tensor  # (N_LAT_BINS,) f32 write-latency histogram

    # observability accumulators (zero-length when the instrument is off)
    obs_lat_mode: torch.Tensor  # (3|0, N_LAT_BINS) per-mode read counts
    obs_lat_comp: torch.Tensor  # (3|0, N_COMPONENTS, N_LAT_BINS) µs sums
    obs_events: torch.Tensor  # (capacity|0, N_EV_FIELDS) f32 event ring
    obs_ev_count: torch.Tensor  # i32 — true total events emitted
    obs_ts: torch.Tensor  # (windows|0, N_SERIES) windowed time series

    # counters (f32 scalars)
    svc_sum_ms: torch.Tensor
    q_sum_ms: torch.Tensor
    chanq_sum_ms: torch.Tensor
    n_reads: torch.Tensor
    n_writes: torch.Tensor
    n_retries: torch.Tensor
    n_migrated_pages: torch.Tensor
    n_reloc_pages: torch.Tensor
    n_erases: torch.Tensor
    n_conversions: torch.Tensor  # (3,3) from-mode x to-mode counts
    n_uncorrectable: torch.Tensor
    n_prog_fails: torch.Tensor
    n_erase_fails: torch.Tensor
    n_dropped_writes: torch.Tensor
    n_rebuilds: torch.Tensor
    n_data_loss: torch.Tensor
    n_degraded_writes: torch.Tensor


def init_state(cfg: geometry.SimConfig, initial_pe=None, spare_blocks=None,
               device=None) -> SSDState:
    """Pre-filled device on ``device`` (CUDA unless the caller names one):
    the L logical pages written sequentially into QLC blocks, the remaining
    blocks free. ``initial_pe`` / ``spare_blocks`` optionally override the
    config's (a number or a 0-dim tensor; negative spares = unbounded)."""
    device = resolve_device(device)
    B, S, L = cfg.n_blocks, cfg.n_slots, cfg.n_logical
    spb = cfg.slots_per_block
    assert L <= S, "working set must fit the device"
    n_full = L // spb
    rem = L - n_full * spb
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    lpn = torch.arange(L, **i32)
    p2l = torch.cat([lpn, torch.full((S - L,), -1, **i32)])

    blk = torch.arange(B, **i32)
    used_full = blk < n_full
    part = (blk == n_full) & (rem > 0)
    block_state = torch.where(used_full, FULL, torch.where(part, OPEN, FREE)).to(torch.int32)
    block_next = torch.where(used_full, spb, torch.where(part, rem, 0)).to(torch.int32)

    free = block_state == FREE
    # lowest-numbered free block per die seeds the allocation hints
    hint = ops.segment_min(torch.where(free, blk, B).to(torch.int32),
                           cfg.die_of_block(blk), cfg.n_dies)
    free_hint = torch.where(hint < B, hint, -1).to(torch.int32)

    sb = ops.scalar(cfg.spare_blocks if spare_blocks is None else spare_blocks, torch.int32,
                    device)
    spare_total = torch.where(sb < 0, SPARE_UNLIMITED, sb).to(torch.int32)
    pe = ops.scalar(cfg.initial_pe if initial_pe is None else initial_pe, torch.int32, device)

    def zero():
        return torch.zeros((), **f32)

    return SSDState(
        l2p=lpn.clone(),
        p2l=p2l,
        page_write_ms=torch.zeros((S,), **f32),
        block_mode=torch.full((B,), modes.QLC, **i32),
        block_state=block_state,
        block_pe=pe.expand(B).clone(),
        block_reads=torch.zeros((B,), **i32),
        block_next=block_next,
        block_valid=block_next.clone(),
        block_cold_age=torch.zeros((B,), **i32),
        block_bad=torch.zeros((B,), dtype=torch.bool, device=device),
        bad_count=torch.zeros((), **i32),
        spare_total=spare_total,
        spare_count=spare_total.clone(),
        heat=torch.zeros((L,), **f32),
        open_user=torch.full((cfg.n_dies,), -1, **i32),
        open_mig=torch.full((3,), -1, **i32),
        free_count=free.sum().to(torch.int32),
        free_hint=free_hint,
        clock_ms=zero(),
        die_busy_ms=torch.zeros((cfg.n_dies,), **f32),
        chan_busy_ms=torch.zeros((cfg.n_channels,), **f32),
        die_avail_ms=torch.zeros((cfg.n_dies,), **f32),
        chan_avail_ms=torch.zeros((cfg.n_channels,), **f32),
        lat_hist=torch.zeros((telemetry.N_LAT_BINS,), **f32),
        w_lat_hist=torch.zeros((telemetry.N_LAT_BINS,), **f32),
        **obs.init_leaves(cfg, device),
        svc_sum_ms=zero(),
        q_sum_ms=zero(),
        chanq_sum_ms=zero(),
        n_reads=zero(),
        n_writes=zero(),
        n_retries=zero(),
        n_migrated_pages=zero(),
        n_reloc_pages=zero(),
        n_erases=zero(),
        n_conversions=torch.zeros((3, 3), **f32),
        n_uncorrectable=zero(),
        n_prog_fails=zero(),
        n_erase_fails=zero(),
        n_dropped_writes=zero(),
        n_rebuilds=zero(),
        n_data_loss=zero(),
        n_degraded_writes=zero(),
    )


def check_invariants(s: SSDState, cfg: geometry.SimConfig, where: str = "") -> None:
    """Assert full-state FTL consistency on the host (a test helper): the
    l2p/p2l bijection, ``block_valid`` equal to a recount, valid slots inside
    each block's programmed window, block metadata in range, exact
    ``free_count``, bad-block and spare-pool accounting, free hints on their
    own die, and open cursors pointing at OPEN blocks of the right mode."""
    from repro_torch import convert  # deferred: convert builds states from this module

    s = convert.ssd_state_to_numpy(s)
    tag = f" [{where}]" if where else ""
    spb = cfg.slots_per_block
    B, L = cfg.n_blocks, cfg.n_logical
    l2p = s.l2p
    p2l = s.p2l

    # -- mapping bijection --
    mapped = l2p >= 0
    assert (l2p[mapped] < cfg.n_slots).all(), f"l2p out of range{tag}"
    assert (p2l[l2p[mapped]] == np.arange(L)[mapped]).all(), \
        f"l2p -> p2l mismatch{tag}"
    vslots = np.nonzero(p2l >= 0)[0]
    assert (p2l[vslots] < L).all(), f"p2l out of range{tag}"
    assert (l2p[p2l[vslots]] == vslots).all(), f"p2l -> l2p mismatch{tag}"

    # -- per-block accounting --
    bv = s.block_valid
    counts = np.bincount(vslots // spb, minlength=B)
    assert (bv == counts).all(), \
        f"block_valid recount mismatch at {np.nonzero(bv != counts)[0][:8]}{tag}"
    bm = s.block_mode
    bs = s.block_state
    bn = s.block_next
    assert ((bm >= 0) & (bm < modes.N_MODES)).all(), f"block_mode range{tag}"
    assert ((bs >= FREE) & (bs <= BAD)).all(), f"block_state range{tag}"
    ppb = geometry.pages_per_block_host(cfg)
    nonfree = bs != FREE
    assert (bn[nonfree] <= ppb[bm[nonfree]]).all(), f"block_next > pages{tag}"
    assert (bn >= bv).all(), f"valid pages exceed programmed pages{tag}"
    assert (bn[bs == FREE] == 0).all() and (bv[bs == FREE] == 0).all(), \
        f"FREE block with programmed/valid pages{tag}"

    # -- bad-block accounting (DESIGN.md §2D) --
    bad = s.block_bad
    assert (bad == (bs == BAD)).all(), f"block_bad / block_state BAD mismatch{tag}"
    assert int(s.bad_count) == int(bad.sum()), \
        f"bad_count {int(s.bad_count)} != recount {int(bad.sum())}{tag}"
    assert (bn[bad] == 0).all() and (bv[bad] == 0).all(), \
        f"retired block with programmed/valid pages{tag}"
    total, remaining = int(s.spare_total), int(s.spare_count)
    assert total >= 0, f"negative spare_total{tag}"
    assert remaining == max(total - int(bad.sum()), 0), \
        f"spare_count {remaining} != max({total} - {int(bad.sum())}, 0){tag}"
    assert (vslots % spb < bn[vslots // spb]).all(), \
        f"valid slot past block_next{tag}"

    # -- free-pool bookkeeping --
    assert int(s.free_count) == int((bs == FREE).sum()), \
        f"free_count {int(s.free_count)} != recount {int((bs == FREE).sum())}{tag}"
    hint = s.free_hint
    assert ((hint >= -1) & (hint < B)).all(), f"free_hint range{tag}"
    live = hint >= 0
    assert (hint[live] % cfg.n_dies == np.arange(cfg.n_dies)[live]).all(), \
        f"free_hint off its die{tag}"

    # -- allocation cursors --
    for name, cur in (("open_user", s.open_user), ("open_mig", s.open_mig)):
        openc = cur >= 0
        assert ((cur >= -1) & (cur < B)).all(), f"{name} range{tag}"
        assert (bs[cur[openc]] == OPEN).all(), f"{name} -> non-OPEN block{tag}"
    om = s.open_mig
    assert (bm[om[om >= 0]] == np.arange(3)[om >= 0]).all(), \
        f"open_mig block mode mismatch{tag}"


def usable_capacity_pages(state: SSDState, cfg: geometry.SimConfig, xp=torch):
    """Usable capacity in pages: non-free blocks at their mode's page count,
    free blocks at QLC density, retired blocks at 0. ``xp=numpy`` computes on
    numpy leaves on the host (``engine.summarize``); the default, int32 on
    the state's device."""
    if xp is torch:
        ppb = geometry.pages_per_block(cfg, state.block_mode.device)
        per_block = torch.where(state.block_state == FREE, ppb[modes.QLC],
                                ppb[state.block_mode.long()])
        per_block = torch.where(state.block_state == BAD, 0, per_block)
        return per_block.sum().to(torch.int32)
    ppb = geometry.pages_per_block_host(cfg)
    per_block = np.where(state.block_state == FREE, ppb[modes.QLC], ppb[state.block_mode])
    per_block = np.where(state.block_state == BAD, 0, per_block)
    return per_block.sum()


def capacity_gib(state: SSDState, cfg: geometry.SimConfig, xp=torch):
    # float cast first: pages * page_bytes overflows int32 at real geometry
    pages = usable_capacity_pages(state, cfg, xp)
    pages = pages.float() if xp is torch else pages.astype(np.float32)
    return pages * cfg.page_bytes / 2**30
