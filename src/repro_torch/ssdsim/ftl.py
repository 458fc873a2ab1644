"""FTL mechanics: block allocation, page-granular conversion migration
(paper Fig. 8-10), fused multi-victim GC and fused reclaim demotion.

Counterpart of ``repro.ssdsim.ftl``. All background block relocation (GC,
reclaim demotion, block conversion) is one code path,
:func:`relocate_group`: it gathers the victims' valid pages, books their
Eq.-3 read cost, places them through :func:`_place_pages` and erases every
victim in one :func:`_erase_many`.

Every gate the reference takes with ``lax.cond`` (``maybe_migrate_pages``,
``reclaim_victims``, ``gc_step``, ``_gc_pass``) is a Python branch on a
0-dim device bool here, one host sync each; when the gate is false the state
comes back unchanged, as the reference's no-op branch gives it. The
allocator's hint-or-scan choice is a ``torch.where`` between both (the
scan is cheap), so it makes the host wait for nothing. The sequential
paths (``_erase``, ``_migrate_block_reference``, ``gc_pass_reference``,
``gc_step_reference``) are test oracles, as in the reference: one block at a
time on host ints, held against the fused kernel by the tests; nothing on
the main path calls them.

Scatter discipline, as in the reference: masked-out lanes go to an
out-of-range index and are dropped (``repro_torch.ops``).
"""

from __future__ import annotations

import torch

from repro_torch import ops
from repro_torch.core import faults as flt
from repro_torch.core import modes, reclaim, retry
from repro_torch.ssdsim import geometry, obs, state as st

# Max destination blocks one conversion can need: one partially-filled open
# migration block plus ceil(1024/256) = 4 fresh SLC blocks.
MAX_DEST = 5

# upper bound on per-block P/E for the youngest-first composite key: the
# die-affinity bonus must dominate any wear difference, so P/E clips here
_ALLOC_PE_CAP = 1 << 22

_MS = ops.recip32(1000.0)  # µs -> ms, the reference's compiled division
_HOUR = ops.recip32(3.6e6)  # ms -> h


def _i32(x):
    return x.to(torch.int32)


def page_age_h(s: st.SSDState, cfg: geometry.SimConfig, write_ms):
    """Retention age in hours of pages programmed at ``write_ms``:
    ``device_age_h + (clock_ms - write_ms) / 3.6e6`` with the reference's
    roundings — its compiled program multiplies by the float32 reciprocal
    and fuses that multiply with the add (one rounding, an FMA), which the
    port takes through float64, where the float32 product is exact."""
    age = torch.full((), cfg.device_age_h, dtype=torch.float32, device=write_ms.device)
    return (age.double() + (s.clock_ms - write_ms).double() * _HOUR).float()


def _mode_table(values, mode):
    return modes.table(values, mode.device)[mode.long()]


def _alloc_scan(s: st.SSDState, prefer_lun=None, cfg: geometry.SimConfig | None = None):
    """Full block_state scan (slow path): free block, prefer matching die."""
    free = s.block_state == st.FREE
    if prefer_lun is not None:
        blk = torch.arange(s.block_mode.shape[0], dtype=torch.int32, device=free.device)
        lun_match = cfg.die_of_block(blk) == prefer_lun
        score = free.to(torch.int32) * 2 + (free & lun_match).to(torch.int32)
    else:
        score = free.to(torch.int32)
    idx = _i32(torch.argmax(score))
    return torch.where(ops.index0(score, idx) > 0, idx, -1).to(torch.int32)


def _alloc_scan_youngest(s: st.SSDState, prefer_lun=None,
                         cfg: geometry.SimConfig | None = None):
    """Wear-levelled scan: the lowest-P/E free block, die affinity first,
    equal wear to the lowest block id."""
    free = s.block_state == st.FREE
    pe = torch.clamp(s.block_pe, 0, _ALLOC_PE_CAP - 1)
    if prefer_lun is not None:
        blk = torch.arange(s.block_mode.shape[0], dtype=torch.int32, device=free.device)
        mismatch = (cfg.die_of_block(blk) != prefer_lun).to(torch.int32)
        key = mismatch * _ALLOC_PE_CAP + pe
    else:
        key = pe
    key = torch.where(free, key, torch.iinfo(torch.int32).max)
    idx = _i32(torch.argmin(key))
    return torch.where(ops.index0(free, idx), idx, -1).to(torch.int32)


def alloc_free_block(s: st.SSDState, prefer_lun=None, cfg: geometry.SimConfig | None = None):
    """Index of a free block (prefer matching die), or -1 if none: the
    die's free hint where it is still FREE, else the full scan.
    ``cfg.alloc_policy == "youngest"`` always scans for the lowest-P/E free
    block."""
    if cfg is not None and cfg.alloc_policy == "youngest":
        return _alloc_scan_youngest(s, prefer_lun, cfg)
    hints = s.free_hint
    live = (hints >= 0) & (s.block_state[torch.clamp(hints, min=0).long()] == st.FREE)
    if prefer_lun is not None:
        lun = torch.as_tensor(prefer_lun)
        h, hit = ops.index0(hints, lun), ops.index0(live, lun)
    else:
        j = torch.argmax(live.to(torch.int32))
        h, hit = ops.index0(hints, j), ops.index0(live, j)
    return torch.where(hit, h, _alloc_scan(s, prefer_lun, cfg)).to(torch.int32)


def free_block_count(s: st.SSDState):
    """Exact FREE-block count, O(1) via the incremental bookkeeping."""
    return s.free_count


def _book_rebuilds(s: st.SSDState, faults: flt.FaultParams, uncorr, slots,
                   pe, rated, cfg: geometry.SimConfig):
    """Book one batch of uncorrectable reads: count them and, with parity
    rebuild armed, the stripe reconstructions they trigger plus any
    second-fault data loss among the peer reads (DESIGN.md §2D)."""
    n_unc = uncorr.sum().float()
    on = faults.parity_rebuild > 0
    if cfg.n_dies > 1:
        n_rb = torch.where(on, n_unc, 0.0)
        loss = uncorr & on & flt.rebuild_second_fault(
            faults, slots, pe, rated, cfg.n_dies - 1)
        n_dl = loss.sum().float()
    else:  # no stripe peers -> no rebuild, no loss
        n_rb = torch.zeros_like(n_unc)
        n_dl = torch.zeros_like(n_unc)
    return s._replace(
        n_uncorrectable=s.n_uncorrectable + n_unc,
        n_rebuilds=s.n_rebuilds + n_rb,
        n_data_loss=s.n_data_loss + n_dl,
    )


def _per_die(ms, blocks, cfg: geometry.SimConfig):
    """Per-die sums of per-lane busy time; under the lattice model with
    several planes, co-scheduled plane operations on one die pay the max of
    the per-plane sums."""
    if cfg.chan_model == "lattice" and cfg.planes_per_lun > 1:
        per_plane = ops.segment_sum(ms, cfg.plane_slot_of_block(blocks),
                                    cfg.n_dies * cfg.planes_per_die)
        return per_plane.reshape(cfg.n_dies, cfg.planes_per_die).amax(1)
    return ops.segment_sum(ms, cfg.die_of_block(blocks), cfg.n_dies)


def _erase_many(s: st.SSDState, victims, grp, cfg: geometry.SimConfig,
                faults: flt.FaultParams | None = None):
    """Erase every ``grp``-masked victim block in one pass: clear its slot
    window in ``p2l``, reset its metadata, book per-die erase latency and
    refresh ``free_hint``. With ``faults``, each erase draws a failure keyed
    on (block, P/E): a failed block is retired to ``BAD`` / ``block_bad``
    (latency and P/E still paid, slots still cleared) and consumes a
    spare."""
    spb = cfg.slots_per_block
    B = s.block_mode.shape[0]
    vb = torch.clamp(victims, min=0)
    vbl = vb.long()
    bdrop = torch.where(grp, vb, B)  # B = out of range -> dropped
    slots = vb[:, None].long() * spb + torch.arange(spb, device=vb.device)
    p2l = ops.at_set(s.p2l, torch.where(grp[:, None], slots, s.p2l.shape[0]), -1)
    src_mode = s.block_mode[vbl]
    erase_ms = torch.where(grp, _mode_table(modes.ERASE_LATENCY_US, src_mode) * _MS, 0.0)
    die_erase = _per_die(erase_ms, vb, cfg)
    if faults is not None:
        fail = grp & flt.erase_fails(
            faults, flt.block_entity(vb, cfg.n_dies, cfg.planes_per_die),
            s.block_pe[vbl], _mode_table(modes.PE_LIMIT, src_mode),
        )
    else:
        fail = torch.zeros_like(grp)
    freed = grp & ~fail
    # any *freed* block on the die is a valid allocation hint; take the max
    # id (retired blocks must never become hints)
    hint_cand = ops.segment_max(torch.where(freed, vb, -1).to(torch.int32),
                                cfg.die_of_block(vb), cfg.n_dies)
    n_free = _i32(freed.sum())
    n_fail = _i32(fail.sum())
    s = s._replace(
        p2l=p2l,
        block_pe=ops.at_add(s.block_pe, bdrop, 1),
        block_reads=ops.at_set(s.block_reads, bdrop, 0),
        block_state=ops.at_set(s.block_state, bdrop,
                               torch.where(fail, st.BAD, st.FREE).to(torch.int32)),
        block_next=ops.at_set(s.block_next, bdrop, 0),
        block_valid=ops.at_set(s.block_valid, bdrop, 0),
        block_cold_age=ops.at_set(s.block_cold_age, bdrop, 0),
        block_bad=ops.at_set(s.block_bad, torch.where(fail, vb, B), True),
        bad_count=s.bad_count + n_fail,
        # each retirement consumes a spare until the pool runs dry
        spare_count=torch.clamp(s.spare_count - n_fail, min=0),
        free_count=s.free_count + n_free,
        free_hint=torch.where(hint_cand >= 0, hint_cand, s.free_hint).to(torch.int32),
        die_busy_ms=s.die_busy_ms + die_erase,
        n_erases=s.n_erases + grp.sum().float(),
        n_erase_fails=s.n_erase_fails + n_fail.float(),
    )
    if faults is not None and obs.full(cfg):
        zeros = torch.zeros(vb.shape, dtype=torch.float32, device=vb.device)
        s = obs.record_events(
            s, cfg, mask=fail, block=vb, from_mode=src_mode, to_mode=src_mode,
            reason=obs.REASON_BAD_BLOCK, retry_est=zeros, pages=zeros,
        )
    return s


def _erase(s: st.SSDState, blk, cfg: geometry.SimConfig):
    """Erase block ``blk`` (an int or a 0-dim tensor): invalidate its slots,
    bump its P/E, return it to the free pool and make it its die's hint.
    A test oracle (the sequential half of ``_migrate_block_reference``);
    relocation erases through :func:`_erase_many`."""
    spb = cfg.slots_per_block
    blk = int(blk)
    die = cfg.die_of_block(blk)
    erase_us = modes.table(modes.ERASE_LATENCY_US, s.block_mode.device)[int(s.block_mode[blk])]
    s = s._replace(**{k: getattr(s, k).clone() for k in (
        "p2l", "block_pe", "block_reads", "block_state", "block_next", "block_valid",
        "block_cold_age", "free_hint", "die_busy_ms")})
    s.p2l[blk * spb:(blk + 1) * spb] = -1
    s.block_pe[blk] += 1
    s.block_reads[blk] = 0
    s.block_state[blk] = st.FREE
    s.block_next[blk] = 0
    s.block_valid[blk] = 0
    s.block_cold_age[blk] = 0
    s.free_hint[die] = blk
    s.die_busy_ms[die] += erase_us * _MS
    return s._replace(free_count=s.free_count + 1, n_erases=s.n_erases + 1.0)


def _place_pages(s: st.SSDState, lpns, valid, tgt_mode, cfg: geometry.SimConfig,
                 n_dest: int):
    """Append the ``valid``-masked ``lpns`` into open migration block(s) of
    ``tgt_mode`` (a Python int or a 0-dim tensor), opening up to ``n_dest``
    fresh blocks from the free pool. The static unroll carries only the
    per-block bookkeeping and each lane's destination slot; the l2p/p2l/
    timestamp scatters happen once after it. Callers invalidate (or erase)
    the source slots themselves."""
    spb = cfg.slots_per_block
    dev = lpns.device
    ppb = geometry.pages_per_block(cfg, dev)
    S, L = cfg.n_slots, cfg.n_logical
    tm = ops.scalar(tgt_mode, torch.int64, dev)
    ppb_t = ops.index0(ppb, tm)
    write_us = ops.index0(modes.table(modes.WRITE_LATENCY_US, dev), tm)

    lp_safe = torch.clamp(lpns, min=0)
    pos = torch.cumsum(valid.to(torch.int32), 0) - 1  # rank of each valid page
    n_valid = valid.sum()
    consumed = torch.zeros((), dtype=torch.int64, device=dev)
    dest_slot = torch.full(lpns.shape, S, dtype=torch.int64, device=dev)  # S = dropped
    # lattice multi-plane overlap: defer the program charges and fold
    # co-scheduled plane programs on one die to their max after the unroll
    overlap = cfg.chan_model == "lattice" and cfg.planes_per_lun > 1
    prog_blocks: list = []
    prog_ms: list = []
    for _ in range(n_dest):
        cur = ops.index0(s.open_mig, tm)
        fresh = cur < 0
        a = alloc_free_block(s, cfg=cfg)
        d = torch.where(fresh, a, cur)
        dd = torch.clamp(d, min=0).long()  # safe index; all writes masked when d < 0
        start = ops.index0(s.block_next, dd).long()
        usable = torch.where(d >= 0, ppb_t - start, 0)
        take = torch.minimum(torch.clamp(n_valid - consumed, min=0), usable)
        opened = (take > 0) & (d >= 0)
        sel = valid & (pos >= consumed) & (pos < consumed + take) & opened
        dest_slot = torch.where(sel, dd * spb + start + (pos - consumed), dest_slot)

        write_ms = take.float() * write_us * _MS
        is_full = start + take >= ppb_t
        if overlap:
            prog_blocks.append(dd)
            prog_ms.append(write_ms)
            busy = s.die_busy_ms
        else:
            busy = ops.at_add(s.die_busy_ms, cfg.die_of_block(dd), write_ms)
        s = s._replace(
            block_mode=ops.at_set(s.block_mode, dd,
                                  torch.where(opened, tm, ops.index0(s.block_mode, dd).long())),
            block_state=ops.at_set(s.block_state, dd, torch.where(
                opened, torch.where(is_full, st.FULL, st.OPEN), ops.index0(s.block_state, dd))),
            free_count=s.free_count - (opened & fresh).to(torch.int32),
            block_next=ops.at_add(s.block_next, dd, torch.where(opened, take, 0)),
            block_valid=ops.at_add(s.block_valid, dd, torch.where(opened, take, 0)),
            open_mig=ops.at_set(s.open_mig, tm, torch.where(
                opened, torch.where(is_full, -1, d), ops.index0(s.open_mig, tm))),
            die_busy_ms=busy,
        )
        consumed = consumed + take
    if overlap and prog_blocks:
        die_prog = _per_die(torch.stack(prog_ms), torch.stack(prog_blocks), cfg)
        s = s._replace(die_busy_ms=s.die_busy_ms + die_prog)
    placed = dest_slot < S
    lp_idx = torch.where(placed, lpns.long(), L)  # L = dropped
    return s._replace(
        l2p=ops.at_set(s.l2p, lp_idx, dest_slot),
        p2l=ops.at_set(s.p2l, dest_slot, lp_safe),
        page_write_ms=ops.at_set(s.page_write_ms, dest_slot, s.clock_ms),
        # every physical relocation program is a page of write amplification
        n_reloc_pages=s.n_reloc_pages + placed.sum().float(),
    )


def _source_reads(s, faults, cfg, mode, pe, slots, retries, valid):
    """Per-lane µs of reading relocation sources (Eq.-3 senses; with faults,
    over-budget lanes burn the budget and pay recovery) and the state with
    the uncorrectable reads booked."""
    lat_us = retry.read_latency_us(mode, retries)
    if faults is not None:
        mrr = faults.max_read_retries
        rated = _mode_table(modes.PE_LIMIT, mode)
        over = valid & (mrr >= 0) & (retries > mrr)
        uncorr = over | (valid & flt.read_fails(faults, slots, pe, rated))
        rec_us = flt.recovery_us(faults, mode, cfg)
        lat_us = retry.read_latency_us(
            mode, torch.where(over, torch.clamp(mrr, min=0), retries)
        ) + torch.where(uncorr, rec_us, 0.0)
        s = _book_rebuilds(s, faults, uncorr, slots, pe, rated, cfg)
    return s, lat_us


def migrate_block(s: st.SSDState, src, tgt_mode, cfg: geometry.SimConfig,
                  faults: flt.FaultParams | None = None):
    """Move all valid pages of block ``src`` into ``tgt_mode`` and erase it
    (mode conversion, or GC relocation when the mode is the block's own): a
    K=1 call into :func:`relocate_group`. The caller guards the free pool."""
    victims = ops.scalar(src, torch.int32, s.block_mode.device).reshape(1)
    return relocate_group(s, victims, torch.ones((1,), dtype=torch.bool, device=victims.device),
                          tgt_mode, cfg, MAX_DEST, reason=obs.REASON_CONV_BLOCK, faults=faults)


def _migrate_block_reference(s: st.SSDState, src, tgt_mode, cfg: geometry.SimConfig):
    """Sequential block migration: every valid page of block ``src`` (an
    int or a 0-dim tensor) read at its Eq.-3 cost, placed into ``tgt_mode``
    through :func:`_place_pages`, then :func:`_erase`. A test oracle for the
    fused :func:`relocate_group` (``gc_pass_reference`` routes through it)."""
    spb = cfg.slots_per_block
    dev = s.block_mode.device
    src = int(src)
    src_mode = s.block_mode[src]
    slots = src * spb + torch.arange(spb, dtype=torch.int32, device=dev)
    lpns = s.p2l[src * spb:(src + 1) * spb]
    valid = lpns >= 0

    # -- read cost of the source pages (Eq. 1 -> Eq. 3 per page) --
    age_h = page_age_h(s, cfg, s.page_write_ms[src * spb:(src + 1) * spb])
    retries = retry.page_retries(src_mode, s.block_pe[src], age_h, s.block_reads[src], slots)
    read_ms = torch.where(valid, retry.read_latency_us(src_mode, retries), 0.0).sum() * _MS
    die_busy_ms = s.die_busy_ms.clone()
    die_busy_ms[cfg.die_of_block(src)] += read_ms
    s = s._replace(die_busy_ms=die_busy_ms)

    # source slots die with the erase below; no explicit invalidation needed
    s = _place_pages(s, lpns, valid, tgt_mode, cfg, MAX_DEST)

    n_conversions = s.n_conversions.clone()
    n_conversions[int(src_mode), int(tgt_mode)] += 1.0
    s = s._replace(n_migrated_pages=s.n_migrated_pages + valid.sum().float(),
                   n_conversions=n_conversions)
    return _erase(s, src, cfg)


def _dest_unroll(cfg: geometry.SimConfig, n_pages: int) -> int:
    """Destination blocks needed to place ``n_pages`` into the smallest-
    capacity mode (SLC), plus one partially-filled open block."""
    slc_ppb = max(cfg.slots_per_block // 4, 1)
    return -(-n_pages // slc_ppb) + 1


def migrate_pages(s: st.SSDState, lpns, tgt_mode: int, cfg: geometry.SimConfig,
                  faults: flt.FaultParams | None = None):
    """Page-granular conversion migration (paper Fig. 9/10): move the given
    logical pages ((M,) int32, -1-padded) into open block(s) programmed in
    ``tgt_mode``, invalidating their old slots; source blocks are compacted
    later by GC."""
    spb = cfg.slots_per_block
    S = cfg.n_slots
    M = lpns.shape[0]

    lp_safe = torch.clamp(lpns, min=0).long()
    old_slot = s.l2p[lp_safe]
    valid = (lpns >= 0) & (old_slot >= 0)
    old_slot = torch.where(valid, old_slot, 0)
    src_blk = (old_slot // spb).long()
    src_mode = s.block_mode[src_blk]
    # don't "migrate" pages already in the target mode
    valid = valid & (src_mode != tgt_mode)
    n_valid = valid.sum()

    # -- read cost of sources (each page is re-read to migrate) --
    age_h = page_age_h(s, cfg, s.page_write_ms[old_slot.long()])
    pe = s.block_pe[src_blk]
    retries = retry.page_retries(src_mode, pe, age_h, s.block_reads[src_blk], old_slot)
    s, lat_us = _source_reads(s, faults, cfg, src_mode, pe, old_slot, retries, valid)
    rd_ms = torch.where(valid, lat_us, 0.0) * _MS
    die_rd = ops.segment_sum(rd_ms, cfg.die_of_block(src_blk), cfg.n_dies)
    s = s._replace(die_busy_ms=s.die_busy_ms + die_rd)

    # -- invalidate old slots --
    p2l = ops.at_set(s.p2l, torch.where(valid, old_slot, S), -1)
    bv = s.block_valid - ops.segment_sum(valid.to(torch.int32), src_blk,
                                         s.block_valid.shape[0])
    s = s._replace(p2l=p2l, block_valid=bv)

    s = _place_pages(s, lpns, valid, tgt_mode, cfg, _dest_unroll(cfg, M))

    conv = ops.segment_sum(valid.float(), src_mode, 3)
    n_conversions = s.n_conversions.clone()
    n_conversions[:, tgt_mode] += conv
    s = s._replace(n_migrated_pages=s.n_migrated_pages + n_valid.float(),
                   n_conversions=n_conversions)
    if obs.full(cfg):
        # one event per source mode with pages moved this call: block -1
        # (page-granular), conversion weight = pages
        retry_sum = ops.segment_sum(torch.where(valid, retries.float(), 0.0), src_mode,
                                    modes.N_MODES)
        dev = lpns.device
        s = obs.record_events(
            s, cfg,
            mask=conv > 0,
            block=torch.full((modes.N_MODES,), -1, dtype=torch.int32, device=dev),
            from_mode=torch.arange(modes.N_MODES, dtype=torch.int32, device=dev),
            to_mode=torch.full((modes.N_MODES,), tgt_mode, dtype=torch.int32, device=dev),
            reason=obs.REASON_CONV_PAGE,
            retry_est=retry_sum / torch.clamp(conv, min=1.0),
            pages=conv,
        )
    return s


def maybe_migrate_pages(s: st.SSDState, lpns, tgt_mode: int, cfg: geometry.SimConfig,
                        faults: flt.FaultParams | None = None):
    """:func:`migrate_pages` when any lane is live and the free pool has room
    (one host sync); else the state as it was."""
    any_valid = (lpns >= 0).any()
    ok = any_valid & (free_block_count(s) >= _dest_unroll(cfg, lpns.shape[0]) + 2)
    if bool(ok):
        return migrate_pages(s, lpns, tgt_mode, cfg, faults)
    return s


def _demote_dest_unroll(cfg: geometry.SimConfig, tgt_mode: int, n_victims: int) -> int:
    """Destination blocks needed by one fused demotion pass into ``tgt_mode``:
    up to ``n_victims`` source blocks one density level below the target,
    plus one partially-filled open block."""
    ppb = geometry.pages_per_block_host(cfg)
    src_pages = n_victims * int(ppb[tgt_mode - 1])
    return -(-src_pages // int(ppb[tgt_mode])) + 1


def relocate_group(s: st.SSDState, victims, grp, tgt_mode,
                   cfg: geometry.SimConfig, n_dest: int,
                   reason: int = obs.REASON_CONV_BLOCK,
                   faults: flt.FaultParams | None = None):
    """The fused relocation pass (DESIGN.md §2A): migrate every
    ``grp``-masked victim block into ``tgt_mode`` (a Python int or a 0-dim
    tensor) in one placement, then erase all victims in one
    :func:`_erase_many`. ``n_dest`` is the caller's static bound on the
    destination blocks one pass can open; ``reason`` tags the obs events.
    Migration programs are modelled as verified-good; over-budget migration
    reads pay the recovery penalty and count as uncorrectable."""
    spb = cfg.slots_per_block
    dev = victims.device

    vb = torch.clamp(victims, min=0)
    vbl = vb.long()
    slots = vb[:, None].long() * spb + torch.arange(spb, device=dev)[None, :]  # (K, spb)
    lpns = torch.where(grp[:, None], s.p2l[slots], -1)
    valid = lpns >= 0
    src_mode = s.block_mode[vbl]  # (K,)

    # -- read cost of all victim pages, one vectorized Eq.-3 pass --
    age_h = page_age_h(s, cfg, s.page_write_ms[slots])
    pe = s.block_pe[vbl][:, None].expand_as(slots)
    mode2 = src_mode[:, None].expand_as(slots)
    retries = retry.page_retries(mode2, pe, age_h, s.block_reads[vbl][:, None], slots)
    s, lat_us = _source_reads(s, faults, cfg, mode2, pe, slots, retries, valid)
    rd_ms = torch.where(valid, lat_us, 0.0).sum(1) * _MS
    rd_w = torch.where(grp, rd_ms, 0.0)
    s = s._replace(die_busy_ms=s.die_busy_ms + _per_die(rd_w, vb, cfg))

    s = _place_pages(s, lpns.reshape(-1), valid.reshape(-1), tgt_mode, cfg, n_dest)

    tm = ops.scalar(tgt_mode, torch.int64, dev)
    conv_src = torch.where(grp, src_mode.long(), modes.N_MODES)  # N_MODES = dropped
    s = s._replace(
        n_migrated_pages=s.n_migrated_pages + valid.sum().float(),
        n_conversions=_add_conversions(s.n_conversions, conv_src, tm),
    )
    if obs.full(cfg):
        pages = valid.sum(1).float()
        retry_mean = torch.where(valid, retries.float(), 0.0).sum(1) / torch.clamp(pages, min=1.0)
        s = obs.record_events(
            s, cfg, mask=grp, block=vb, from_mode=src_mode,
            to_mode=tm.to(torch.int32).expand(vb.shape), reason=reason,
            retry_est=retry_mean, pages=pages,
        )
    return _erase_many(s, victims, grp, cfg, faults=faults)


def _add_conversions(conv, src, tgt):
    """``conv.at[src, tgt].add(1.0, mode="drop")`` on the (3, 3) counts,
    ``src == 3`` dropped. Counts are integers in float32: exact in any order."""
    flat = torch.where(src < modes.N_MODES, src * modes.N_MODES + tgt, modes.N_MODES**2)
    return ops.at_add(conv.reshape(-1), flat, 1.0).reshape(conv.shape)


def reclaim_victims(s: st.SSDState, victims, v_ok, v_tgt, cfg: geometry.SimConfig,
                    faults: flt.FaultParams | None = None):
    """Fused reclaim demotion (paper §IV-E): the top-k demotion victims in at
    most two masked passes (SLC->TLC, TLC->QLC), each gated (one host sync)
    on having victims and enough free destination blocks."""
    K = victims.shape[0]
    for tgt in (modes.TLC, modes.QLC):
        grp = v_ok & (v_tgt == tgt) & (
            s.block_state[torch.clamp(victims, min=0).long()] == st.FULL)
        ok = grp.any() & (free_block_count(s) >= _demote_dest_unroll(cfg, tgt, K) + 2)
        if bool(ok):
            s = relocate_group(s, victims, grp, tgt, cfg, _demote_dest_unroll(cfg, tgt, K),
                               reason=obs.REASON_RECLAIM, faults=faults)
    return s


def _gc_dest_need(cfg: geometry.SimConfig, k: int) -> int:
    """Free-pool guard headroom for a fused GC pass of up to ``k`` victims."""
    return MAX_DEST + (k - 1)


def select_gc_victims(s: st.SSDState, cfg: geometry.SimConfig, k: int,
                      knobs=None):
    """Top-k GC victims via ``reclaim.score_victims`` among reclaimable FULL
    blocks, ties to the lowest block id; a ``knobs.gc_objective`` code
    overrides the static objective."""
    code = None if knobs is None else getattr(knobs, "gc_objective", None)
    victims, ok, _ = reclaim.score_victims(s, cfg, cfg.gc_objective, k=k,
                                           objective_code=code)
    return victims, ok


def gc_step(s: st.SSDState, cfg: geometry.SimConfig,
            faults: flt.FaultParams | None = None, knobs=None):
    """Fused greedy GC, gated (one host sync) on the free pool falling below
    ``cfg.gc_free_threshold``."""
    need = free_block_count(s) < cfg.gc_free_threshold
    if bool(need):
        return _gc_pass(s, cfg, faults, knobs)
    return s


def _gc_pass(s: st.SSDState, cfg: geometry.SimConfig,
             faults: flt.FaultParams | None = None, knobs=None):
    """One fused GC firing: the top-k victims, batched deficit-aware (forced
    while the projected reclaim is short of the threshold, taken
    opportunistically up to ``k - 1`` blocks beyond it when at least half as
    cheap as the best), relocated in one :func:`relocate_group` pass over the
    batch's dominant source mode, gated (one host sync) on having victims
    and free headroom."""
    k = min(max(int(cfg.gc_victims_per_pass), 1), cfg.n_blocks)
    victims, ok = select_gc_victims(s, cfg, k, knobs)
    vbl = torch.clamp(victims, min=0).long()
    ppb = geometry.pages_per_block(cfg, victims.device)
    vmode = s.block_mode[vbl]
    net = torch.where(ok, 1.0 - s.block_valid[vbl].float() / ppb[vmode.long()].float(), 0.0)
    # projected reclaim of better victims, cumsum(net) - net as the
    # reference takes it: its k-lane cumsum adds one lane at a time in
    # float32, and so does this loop
    run, cum = torch.zeros((), dtype=torch.float32, device=net.device), []
    for i in range(k):
        run = run + net[i]
        cum.append(run)
    cum_before = torch.stack(cum) - net
    deficit = (cfg.gc_free_threshold - free_block_count(s)).float()
    forced = cum_before < deficit
    cheap = net >= 0.5 * net[0]
    ok = ok & (forced | (cheap & (cum_before < deficit + (k - 1))))
    # one relocation pass per firing, on the dominant source mode's victims
    cnt = ops.segment_sum(ok.to(torch.int32), vmode, modes.N_MODES)
    tgt = _i32(torch.argmax(cnt))
    grp = ok & (vmode == tgt) & (s.block_state[vbl] == st.FULL)
    go = grp.any() & (free_block_count(s) >= _gc_dest_need(cfg, k) + 2)
    if bool(go):
        return relocate_group(s, victims, grp, tgt, cfg, k + 1,
                              reason=obs.REASON_GC, faults=faults)
    return s


def gc_step_reference(s: st.SSDState, cfg: geometry.SimConfig):
    """:func:`gc_pass_reference` when the free pool is below
    ``cfg.gc_free_threshold`` (as :func:`gc_step` gates); a test oracle."""
    if int(free_block_count(s)) < cfg.gc_free_threshold:
        return gc_pass_reference(s, cfg)
    return s


def gc_pass_reference(s: st.SSDState, cfg: geometry.SimConfig):
    """The scalar single-victim GC pass: the reclaimable FULL block with the
    fewest valid pages (the lowest id among equals), migrated in its own
    mode by :func:`_migrate_block_reference` when the pool has room. A test
    oracle: the fused :func:`_gc_pass` with ``gc_victims_per_pass=1`` must
    equal it."""
    ppb = geometry.pages_per_block(cfg, s.block_mode.device)
    full = s.block_state == st.FULL
    reclaimable = full & (s.block_valid < ppb[s.block_mode.long()])
    score = torch.where(reclaimable, s.block_valid, torch.iinfo(torch.int32).max)
    victim = int(torch.argmin(score))  # the first minimum, as jnp.argmin
    if bool(reclaimable[victim]) and int(free_block_count(s)) >= MAX_DEST + 2:
        return _migrate_block_reference(s, victim, int(s.block_mode[victim]), cfg)
    return s
