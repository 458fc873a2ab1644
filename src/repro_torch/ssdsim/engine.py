"""Chunked vectorized simulation engine (DESIGN.md §2A).

Counterpart of ``repro.ssdsim.engine``. One step processes ``cfg.chunk``
requests: reads are vectorized (metadata gathers + segment sums), user
writes go through the batched write path, then the policy's per-read
trigger pipeline runs on the chunk's unique read set, and conversion,
reclaim and GC run as pressure-gated background FTL tasks.

Two timing models share the engine (DESIGN.md §2C): closed loop (a trace
without ``arrival_ms``: requests back to back) and open loop (per-request
arrivals, FCFS per die by a vectorized Lindley recursion, and under
``chan_model="lattice"`` a second pass on the channel buses).

Where the reference scans ``step_chunk`` over the chunks inside one
compiled program, :func:`run` loops over them in Python on the device the
caller names (CUDA by default). The reference's ``lax.cond`` gates are
Python branches on 0-dim device bools (``ftl``), one host sync each, and
nothing else in a step makes the host wait.

Floats: every division by a constant is a multiply by its float32
reciprocal and ``device_age_h + Δt / 3.6e6`` is one rounding (``ftl``), as
the reference's compiled program computes them; a channel's transfer time
is its read count's worth of one constant, summed in the reference's order
(``_repeated_sums``); float sums of unequal values (busy times, the Lindley
prefix sums) add in another order than the reference's and agree to
float32 rounding, which feeds no integer decision but through the page
ages, where it is far below one ulp of the age.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import convert, ops, resolve_device
from repro_torch.core import faults as flt
from repro_torch.core import hotness, modes, reclaim, retry
from repro_torch.ssdsim import ftl, geometry, obs, policies, telemetry
from repro_torch.ssdsim import state as st

OP_READ = 0
OP_WRITE = 1

_MS = ops.recip32(1000.0)  # µs -> ms, the reference's compiled division


class ChunkMetrics(NamedTuple):
    capacity_pages: torch.Tensor  # int32
    free_blocks: torch.Tensor  # int32
    mode_hist: torch.Tensor  # (3,) int32 blocks per mode (non-free)
    reads: torch.Tensor
    retries: torch.Tensor
    svc_ms: torch.Tensor  # total recorded read latency this chunk
    migrated: torch.Tensor
    lat_hist: torch.Tensor  # (N_LAT_BINS,) this chunk's read latencies
    w_lat_hist: torch.Tensor  # (N_LAT_BINS,) this chunk's write latencies
    q_ms: torch.Tensor  # total read queueing delay this chunk (0 closed-loop)
    chanq_ms: torch.Tensor  # total read channel-wait this chunk (lattice only)
    user_pages: torch.Tensor  # host pages written this chunk
    reloc_pages: torch.Tensor  # GC/conversion/reclaim pages moved this chunk


def _queue_departures(avail0_ms, arrival_ms, occ_ms, lun, active, n_luns: int):
    """Per-resource FCFS departure times for one chunk (vectorized Lindley):
    ``D_k = P_k + max(avail0, max_{j<=k}(A_j - P_{j-1}))`` per resource
    column, from one masked ``cumsum`` and one masked ``cummax``. Returns
    (per-lane departure times, final per-resource availability), in ms."""
    oh = (lun[:, None] == torch.arange(n_luns, device=lun.device)[None, :]) & active[:, None]
    sv = torch.where(oh, occ_ms[:, None], 0.0)
    prefix = torch.cumsum(sv, 0)  # (C, n_luns) inclusive per-lane P_k
    slack = torch.where(oh, arrival_ms[:, None] - (prefix - sv), -torch.inf)
    m = torch.maximum(torch.cummax(slack, 0).values, avail0_ms[None, :])
    depart = prefix + m
    lane_dep = torch.gather(depart, 1, torch.clamp(lun, 0, n_luns - 1).long()[:, None])[:, 0]
    return lane_dep, depart[-1]


def _tandem_departures(die_avail0, chan_avail0, arrival_ms, die_occ_ms,
                       xfer_ms, die, chan, rd, active, n_dies: int,
                       n_channels: int):
    """Two-resource tandem Lindley recursion (``chan_model="lattice"``): the
    die pass for sense/program occupancy, then the channel pass where each
    transfer queues FCFS on its die's bus, eligible at the die departure
    for a read and at the arrival for a write. Returns ``(die_dep,
    chan_dep, die_avail, chan_avail)``."""
    die_dep, die_avail = _queue_departures(
        die_avail0, arrival_ms, die_occ_ms, die, active, n_dies
    )
    chan_arr = torch.where(rd, die_dep, arrival_ms)
    chan_dep, chan_avail = _queue_departures(
        chan_avail0, chan_arr, xfer_ms, chan, active, n_channels
    )
    return die_dep, chan_dep, die_avail, chan_avail


def lookup(s: st.SSDState, lpns, cfg: geometry.SimConfig):
    """Gather physical metadata + Eq.-3 retry estimate for logical pages:
    (slot, block, mode, retries, ok)."""
    lp = torch.clamp(lpns, min=0).long()
    slot = s.l2p[lp]
    ok = (lpns >= 0) & (slot >= 0)
    slot = torch.where(ok, slot, 0)
    blk = (slot // cfg.slots_per_block).long()
    mode = s.block_mode[blk]
    age_h = ftl.page_age_h(s, cfg, s.page_write_ms[slot.long()])
    retries = retry.page_retries(mode, s.block_pe[blk], age_h, s.block_reads[blk], slot)
    return slot, blk, mode, retries, ok


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.cache
def _repeated_sums(x: float, n: int, device) -> torch.Tensor:
    """(n + 1,) float32 on ``device``: entry k is k copies of ``x`` added one
    at a time in float32. The reference's ``segment_sum`` adds its lanes in
    order; for k equal values that order rounds away from ``k * x`` by up to
    ~1e-5 of the sum at k ~ 1,000, where a tree-ordered sum does not."""
    sums = np.cumsum(np.full(n, x, np.float32), dtype=np.float32)  # sequential, in float32
    return torch.from_numpy(np.concatenate([np.zeros(1, np.float32), sums])).to(device)


def write_path_reference(s: st.SSDState, lpns, is_write, cfg: geometry.SimConfig):
    """Sequential user-write path, one request at a time (the reference's
    per-request ``lax.scan``, here a Python loop over host ints).

    A test oracle only: the property tests hold :func:`write_path_batched`
    to it on arbitrary mixed traces. One loop step per request, so keep it
    to ``tiny_config``-sized chunks. Returns a new state; ``s`` is left as
    it was."""
    spb = cfg.slots_per_block
    ppb_q = int(geometry.pages_per_block_host(cfg)[modes.QLC])
    dev = lpns.device
    w_lat_us = torch.tensor(modes.WRITE_LATENCY_US[modes.QLC] + cfg.transfer_us,
                            dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.bool, device=dev)
    w_ms = _f32(np.float32(modes.WRITE_LATENCY_US[modes.QLC]) * np.float32(_MS))
    written = ("l2p", "p2l", "page_write_ms", "block_mode", "block_state", "block_next",
               "block_valid", "open_user", "die_busy_ms", "free_count", "n_writes")
    s = s._replace(**{k: getattr(s, k).clone() for k in written})  # updated in place below
    active = (is_write & (lpns >= 0)).tolist()
    for lpn, act in zip(torch.clamp(lpns, min=0).tolist(), active):
        if not act:
            continue
        lun = lpn % cfg.n_luns
        d = int(s.open_user[lun])
        need_new = d < 0 or int(s.block_next[d]) >= ppb_q
        d2 = int(ftl.alloc_free_block(s, prefer_lun=lun, cfg=cfg)) if need_new else d
        if d2 < 0:  # no block to write into: the write is lost, the die's cursor closed
            s.open_user[lun] = -1
            continue
        if need_new:  # open a fresh block in QLC mode
            s.block_mode[d2] = modes.QLC
            s.block_state[d2] = st.OPEN
            s.free_count.sub_(1)
        old = int(s.l2p[lpn])
        if old >= 0:  # invalidate the previous mapping
            s.p2l[old] = -1
            s.block_valid[old // spb] -= 1
        slot = d2 * spb + int(s.block_next[d2])
        full = int(s.block_next[d2]) + 1 >= ppb_q
        s.l2p[lpn] = slot
        s.p2l[slot] = lpn
        s.page_write_ms[slot] = s.clock_ms
        s.block_next[d2] += 1
        s.block_valid[d2] += 1
        if full:
            s.block_state[d2] = st.FULL
        s.open_user[lun] = -1 if full else d2
        s.die_busy_ms[lun] += w_ms
        s.n_writes.add_(1.0)
        s = s._replace(w_lat_hist=telemetry.record(s.w_lat_hist, w_lat_us, one))
    return s


def write_path_batched(s: st.SSDState, lpns, is_write, cfg: geometry.SimConfig,
                       w_lat_us=None, faults: flt.FaultParams | None = None):
    """Vectorized user-write path (DESIGN.md §2A): writes grouped by die get
    destination slots from per-die prefix sums against ``block_next``; each
    open-block rollover is an allocation *event* of a static unroll
    (``n_dies * ceil(chunk / pages_per_qlc_block)`` of them), replayed in
    request order; every mapping and accounting update is a masked scatter.

    ``w_lat_us`` optionally overrides the latency each write records (the
    open-loop sojourn). With ``faults``, each program draws a failure; a
    failed last write of an LPN is re-placed through ``ftl._place_pages``,
    and what cannot be seated is a dropped write (counted, never a corrupted
    mapping); a spare pool run dry refuses the chunk's writes (degraded)."""
    dev = lpns.device
    spb = cfg.slots_per_block
    ppb_q = int(geometry.pages_per_block_host(cfg)[modes.QLC])
    C = lpns.shape[0]
    nL, B = cfg.n_luns, cfg.n_blocks
    S, L = cfg.n_slots, cfg.n_logical
    w_ms = _f32(np.float32(modes.WRITE_LATENCY_US[modes.QLC]) / np.float32(1000.0))

    lp = torch.clamp(lpns, min=0)
    w = is_write & (lpns >= 0)
    if faults is not None:
        # spare-pool exhaustion flips the device read-only (DESIGN.md §2D)
        degraded = s.spare_count <= 0
        n_degraded = (w & degraded).sum().float()
        w = w & ~degraded
        s = s._replace(n_degraded_writes=s.n_degraded_writes + n_degraded)
    lun = (lp % nL).to(torch.int32)

    # per-die write ranks via prefix sums
    oh = (lun[:, None] == torch.arange(nL, device=dev)[None, :]) & w[:, None]
    cum = torch.cumsum(oh.to(torch.int32), 0)
    rank = torch.gather(cum, 1, lun.long()[:, None])[:, 0] - 1
    nw = cum[-1]  # (nL,) writes per die

    d0 = s.open_user
    d0l = torch.clamp(d0, min=0).long()
    next0 = torch.where(d0 >= 0, s.block_next[d0l], 0)
    avail0 = torch.where(d0 >= 0, torch.clamp(ppb_q - next0, min=0), 0)

    # ---- allocation events: one per open-block rollover ----
    n_ev = -(-C // ppb_q)
    E = nL * n_ev
    lunl = lun.long()
    over = rank - avail0[lunl]  # this write's slot count past the open block
    is_trig = w & (over >= 0) & (over % ppb_q == 0)
    ev = lunl * n_ev + torch.clamp(torch.div(over, ppb_q, rounding_mode="floor"), 0, n_ev - 1)
    pos_i = torch.arange(C, dtype=torch.int32, device=dev)
    trig_pos = ops.at_min(torch.full((E,), C, dtype=torch.int32, device=dev),
                          torch.where(is_trig, ev, E), pos_i)
    order = torch.argsort(trig_pos, stable=True)  # triggered events first, in request order

    dest_ev = torch.full((E,), -1, dtype=torch.int32, device=dev)
    for j in range(E):  # static unroll; E is a handful of events
        e = order[j]
        active = ops.index0(trig_pos, e) < C
        a = ftl.alloc_free_block(s, prefer_lun=torch.div(e, n_ev, rounding_mode="floor"), cfg=cfg)
        got = active & (a >= 0)
        aa = torch.clamp(a, min=0).long()
        dest_ev = ops.at_set(dest_ev, e, torch.where(got, a, -1))
        s = s._replace(
            block_mode=ops.at_set(s.block_mode, aa,
                                  torch.where(got, modes.QLC, ops.index0(s.block_mode, aa))),
            block_state=ops.at_set(s.block_state, aa,
                                   torch.where(got, st.OPEN, ops.index0(s.block_state, aa))),
            free_count=s.free_count - got.to(torch.int32),
        )

    # ---- per-write destination slots ----
    in_open = w & (over < 0)
    over0 = torch.clamp(over, min=0)
    ev_i = lunl * n_ev + torch.clamp(torch.div(over0, ppb_q, rounding_mode="floor"), 0, n_ev - 1)
    dest_blk = torch.where(in_open, d0[lunl], dest_ev[ev_i])
    off = torch.where(in_open, next0[lunl] + rank, over0 % ppb_q)
    ok = w & (dest_blk >= 0)
    db = torch.clamp(dest_blk, min=0)
    dbl = db.long()
    slot = db.long() * spb + off

    # program-failure draw: a failed lane still consumes its slot but never
    # maps; its data is re-placed after the scatters commit
    if faults is not None:
        pfail = ok & flt.prog_fails(
            faults, slot, s.block_pe[dbl],
            modes.table(modes.PE_LIMIT, dev)[s.block_mode[dbl].long()])
    else:
        pfail = torch.zeros_like(ok)

    # duplicate LPNs within the chunk: only the last attempted write
    # supersedes the mapping; earlier ones still consume slots
    last_pos = ops.at_max(torch.full((L,), -1, dtype=torch.int32, device=dev),
                          torch.where(ok, lp, L), pos_i)
    lpl = lp.long()
    is_last = ok & (last_pos[lpl] == pos_i)
    mapped = is_last & ~pfail
    refail = is_last & pfail

    # invalidate pre-chunk mappings, once per unique written LPN
    old = s.l2p[lpl]
    inv = is_last & (old >= 0)
    old_safe = torch.clamp(old, min=0)

    l2p = ops.at_set(s.l2p, torch.where(mapped, lp, L), slot)
    l2p = ops.at_set(l2p, torch.where(refail, lp, L), -1)
    p2l = ops.at_set(s.p2l, torch.where(ok, slot, S), torch.where(mapped, lp, -1))
    p2l = ops.at_set(p2l, torch.where(inv, old, S), -1)
    pwt = ops.at_set(s.page_write_ms, torch.where(ok, slot, S), s.clock_ms)

    oki = ok.to(torch.int32)
    bn_add = ops.segment_sum(oki, db, B)
    bv_add = ops.segment_sum(mapped.to(torch.int32), db, B)
    bv_sub = ops.segment_sum(inv.to(torch.int32), old_safe // spb, B)
    block_next = s.block_next + bn_add
    block_valid = s.block_valid + bv_add - bv_sub
    touched = bn_add > 0
    block_state = torch.where(
        touched, torch.where(block_next >= ppb_q, st.FULL, st.OPEN), s.block_state
    ).to(torch.int32)

    # final open-block cursor per die (the sequential path's last-write outcome)
    last_over = (nw - 1) - avail0
    last_ev = torch.arange(nL, device=dev) * n_ev + torch.clamp(
        torch.div(torch.clamp(last_over, min=0), ppb_q, rounding_mode="floor"), 0, n_ev - 1)
    d_last = torch.where(last_over < 0, d0, dest_ev[last_ev])
    last_full = block_next[torch.clamp(d_last, min=0).long()] >= ppb_q
    open_user = torch.where(
        nw > 0, torch.where((d_last >= 0) & ~last_full, d_last, -1), s.open_user
    ).to(torch.int32)

    okc = ops.segment_sum(oki, lun, nL)
    if w_lat_us is None:
        w_lat_us = torch.full(
            (C,), _f32(np.float32(modes.WRITE_LATENCY_US[modes.QLC])
                       + np.float32(cfg.transfer_us)),
            dtype=torch.float32, device=dev)
    busy_luns = okc.float() * w_ms
    if faults is not None:
        # graceful degradation: allocation-exhausted writes stall their die
        # for a program time
        drop_alloc = w & ~ok
        busy_luns = busy_luns + ops.segment_sum(drop_alloc.float(), lun, nL) * w_ms
    s = s._replace(
        l2p=l2p,
        p2l=p2l,
        page_write_ms=pwt,
        block_next=block_next,
        block_valid=block_valid,
        block_state=block_state,
        open_user=open_user,
        die_busy_ms=s.die_busy_ms + busy_luns,
        n_writes=s.n_writes + ok.sum().float(),
        w_lat_hist=telemetry.record(s.w_lat_hist, w_lat_us, ok),
    )
    if faults is not None:
        # re-place the data of failed last-attempt programs onto fresh
        # block(s); anything that could not be seated is a dropped write
        s = s._replace(n_prog_fails=s.n_prog_fails + pfail.sum().float())
        s = ftl._place_pages(s, lp, refail, modes.QLC, cfg, -(-C // ppb_q) + 1)
        still = refail & (s.l2p[lpl] < 0)
        n_drop = (drop_alloc.sum() + still.sum()).float()
        s = s._replace(n_dropped_writes=s.n_dropped_writes + n_drop)
    return s


def step_chunk(s: st.SSDState, req, cfg: geometry.SimConfig, has_writes: bool,
               knobs: policies.RunKnobs | None = None):
    """One engine step. ``req`` is ``(lpns, ops)`` for the closed-loop model
    or ``(lpns, ops, arrival_ms)`` for the open-loop one, tensors on the
    state's device. ``knobs`` optionally overrides the per-run policy and
    wear knobs. Returns (state, ChunkMetrics)."""
    lpns, op = req[0], req[1]
    arrival = req[2] if len(req) == 3 else None
    dev = lpns.device
    is_read = op == OP_READ
    fp = flt.params_for(cfg, knobs, dev)  # None = no fault op at all
    # chunk-start write counters: the windowed WAF series is per-chunk deltas
    w_c0, r_c0 = s.n_writes, s.n_reloc_pages
    read_us = modes.table(modes.READ_LATENCY_US, dev)
    xfer = _f32(cfg.transfer_us)

    # ---------------- reads (vectorized) ----------------
    slot, blk, mode, retries, ok = lookup(s, lpns, cfg)
    rd = is_read & ok
    svc_us = torch.where(rd, retry.read_latency_us(mode, retries), 0.0)
    if fp is not None:
        # uncorrectable reads (DESIGN.md §2D): over-budget retry estimates
        # burn the budget and pay the recovery penalty; every read also
        # draws a wear-scaled probabilistic uncorrectable
        mrr = fp.max_read_retries
        pe_r = s.block_pe[blk]
        rated_r = modes.table(modes.PE_LIMIT, dev)[mode.long()]
        over = rd & (mrr >= 0) & (retries > mrr)
        uncorr = over | (rd & flt.read_fails(fp, slot, pe_r, rated_r))
        retries = torch.where(over, torch.clamp(mrr, min=0), retries)
        rec_us = flt.recovery_us(fp, mode, cfg)
        svc_us = torch.where(
            rd, retry.read_latency_us(mode, retries) + torch.where(uncorr, rec_us, 0.0), 0.0)
        if cfg.n_dies > 1:
            is_rb = uncorr & (fp.parity_rebuild > 0)
        else:
            is_rb = torch.zeros_like(uncorr)
        rb_lane_us = torch.where(is_rb, rec_us, 0.0)
    else:
        uncorr = None
        rb_lane_us = torch.zeros_like(svc_us)
    xfer_us = torch.where(rd, xfer, 0.0)
    die = cfg.die_of_block(blk)
    chan = cfg.channel_of_die(die)

    # ---------------- open-loop queueing (DESIGN.md §2C) ----------------
    if arrival is not None:
        if knobs is None or knobs.arrival_scale is None:
            t_arr = arrival  # divided by the constant 1.0: unchanged
        else:
            t_arr = arrival / ops.scalar(knobs.arrival_scale, torch.float32, dev)
        wv = (op == OP_WRITE) & (lpns >= 0)
        active = rd | wv
        q_die = torch.where(rd, die, torch.clamp(lpns, min=0) % cfg.n_dies).to(torch.int32)
        w_us = float(modes.WRITE_LATENCY_US[modes.QLC])
        occ_us = torch.where(rd, svc_us, w_us)
        occ_ms = torch.where(active, occ_us, 0.0) * _MS
        if cfg.chan_model == "lattice":
            die_dep, chan_dep, die_avail, chan_avail = _tandem_departures(
                s.die_avail_ms, s.chan_avail_ms, t_arr, occ_ms,
                torch.where(active, xfer, 0.0) * _MS,
                q_die, cfg.channel_of_die(q_die), rd, active,
                cfg.n_dies, cfg.n_channels,
            )
            dep_ms = torch.where(rd, chan_dep, die_dep)
            sojourn_us = torch.where(
                rd, (chan_dep - t_arr) * 1000.0, ops.fma32(die_dep - t_arr, 1000.0, xfer))
            queue_us = torch.clamp(ops.fma32(die_dep - t_arr, 1000.0, -occ_us), min=0.0)
            chanw_us = torch.where(
                rd, torch.clamp(ops.fma32(chan_dep - die_dep, 1000.0, -xfer), min=0.0), 0.0)
        else:
            # legacy: channel transfer is appended to the recorded latency
            # but does not occupy a resource
            dep_ms, die_avail = _queue_departures(
                s.die_avail_ms, t_arr, occ_ms, q_die, active, cfg.n_dies)
            chan_avail = s.chan_avail_ms
            sojourn_us = ops.fma32(dep_ms - t_arr, 1000.0, xfer)
            queue_us = torch.clamp(sojourn_us - occ_us - xfer, min=0.0)
            chanw_us = torch.zeros_like(queue_us)
        lat_rec = sojourn_us  # queue + sense/retry (or program) + wait + transfer
        chunk_q = torch.where(rd, queue_us, 0.0).sum() * _MS
        chunk_chanw = torch.where(rd, chanw_us, 0.0).sum() * _MS
        chunk_svc = torch.where(rd, lat_rec, 0.0).sum() * _MS
    else:
        chunk_q = torch.zeros((), dtype=torch.float32, device=dev)
        chunk_chanw = torch.zeros((), dtype=torch.float32, device=dev)
        chunk_svc = (svc_us + xfer_us).sum() * _MS
        lat_rec = svc_us + xfer_us
    chunk_hist = telemetry.record(
        torch.zeros((telemetry.N_LAT_BINS,), dtype=torch.float32, device=dev), lat_rec, rd)

    die_add = ops.segment_sum(svc_us, die, cfg.n_dies) * _MS
    # every read's transfer is the same constant, so a channel's sum is its
    # read count's worth of it, added one lane at a time in float32 as the
    # reference's segment sum adds them
    n_xfer = ops.segment_sum(rd.to(torch.int32), chan, cfg.n_channels)
    chan_add = _repeated_sums(xfer, lpns.shape[0], dev)[n_xfer.long()] * _MS
    chunk_reads = rd.sum().float()
    chunk_retries = torch.where(rd, retries, 0).sum().float()

    s = s._replace(
        die_busy_ms=s.die_busy_ms + die_add,
        chan_busy_ms=s.chan_busy_ms + chan_add,
        block_reads=s.block_reads + ops.segment_sum(rd.to(torch.int32), blk, cfg.n_blocks),
        svc_sum_ms=s.svc_sum_ms + chunk_svc,
        q_sum_ms=s.q_sum_ms + chunk_q,
        chanq_sum_ms=s.chanq_sum_ms + chunk_chanw,
        n_reads=s.n_reads + chunk_reads,
        n_retries=s.n_retries + chunk_retries,
        lat_hist=s.lat_hist + chunk_hist,
    )
    if uncorr is not None:
        # die-parity rebuild accounting: a second uncorrectable among the
        # stripe peers during the rebuild is true data loss
        n_rb = is_rb.sum().float()
        if cfg.n_dies > 1:
            loss = is_rb & flt.rebuild_second_fault(fp, slot, pe_r, rated_r, cfg.n_dies - 1)
            n_dl = loss.sum().float()
        else:
            n_dl = torch.zeros_like(n_rb)
        s = s._replace(
            n_uncorrectable=s.n_uncorrectable + uncorr.sum().float(),
            n_rebuilds=s.n_rebuilds + n_rb,
            n_data_loss=s.n_data_loss + n_dl,
        )

    # ---------------- observability: read-path attribution ----------------
    if obs.enabled(cfg):
        base_us = torch.where(rd, read_us[mode.long()], 0.0)
        if arrival is not None:
            q_us = torch.where(rd, queue_us, 0.0)
            cw_us = torch.where(rd, chanw_us, 0.0)
            t_read_ms = dep_ms  # window by each read's own departure time
        else:
            q_us = torch.zeros_like(svc_us)
            cw_us = torch.zeros_like(svc_us)
            t_read_ms = s.clock_ms.expand(svc_us.shape)
        s = obs.record_reads(
            s, cfg, mode=mode, rd=rd, lat_us=lat_rec, queue_us=q_us,
            sense_us=base_us, retry_us=svc_us - base_us - rb_lane_us,
            chanw_us=cw_us, xfer_us=xfer_us, retries=retries, t_ms=t_read_ms,
            uncorr=uncorr, rebuild_us=rb_lane_us,
        )
        obs0 = (s.n_writes, s.n_conversions.sum(), s.n_erases,
                s.n_migrated_pages, s.n_reloc_pages)

    # ---------------- heat update ----------------
    touched = rd | (op == OP_WRITE)
    heat = hotness.decay_heat(s.heat, cfg.heat)
    s = s._replace(heat=hotness.accumulate(heat, torch.where(touched, lpns, cfg.n_logical)))

    # ---------------- user writes ----------------
    if has_writes:
        w_hist0 = s.w_lat_hist
        s = write_path_batched(
            s, lpns, op == OP_WRITE, cfg,
            w_lat_us=lat_rec if arrival is not None else None, faults=fp)
        chunk_w_hist = s.w_lat_hist - w_hist0
    else:
        chunk_w_hist = torch.zeros((telemetry.N_LAT_BINS,), dtype=torch.float32, device=dev)

    # background FTL work from here on extends the die availability clocks
    busy_mark = s.die_busy_ms

    # die-parity rebuild peer charges: a sense per peer die, a transfer per
    # peer page on its channel (exactly 0.0 with parity rebuild off)
    if fp is not None and cfg.n_dies > 1:
        rb_sense_us = torch.where(is_rb, read_us[mode.long()], 0.0)
        own_sense = ops.segment_sum(rb_sense_us, die, cfg.n_dies)
        rb_die_ms = (rb_sense_us.sum() - own_sense) * _MS
        n_rb_chan = ops.segment_sum(is_rb.float(), chan, cfg.n_channels)
        rb_chan_ms = ((is_rb.sum().float() * cfg.luns_per_channel - n_rb_chan) * xfer) * _MS
        s = s._replace(die_busy_ms=s.die_busy_ms + rb_die_ms,
                       chan_busy_ms=s.chan_busy_ms + rb_chan_ms)
        if arrival is not None and cfg.chan_model == "lattice":
            chan_avail = chan_avail + rb_chan_ms

    # ---------------- policy: conversion migrations ----------------
    if cfg.policy != geometry.BASELINE:
        # dedup of the chunk's read set: sort + adjacent-equal mask; masked
        # lanes sort to the top as n_logical and drop to -1
        srt = torch.sort(torch.where(rd, lpns, cfg.n_logical)).values
        dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev), srt[1:] == srt[:-1]])
        uniq = torch.where((srt >= cfg.n_logical) | dup, -1, srt).to(torch.int32)
        slot_u, blk_u, mode_u, retr_u, ok_u = lookup(s, uniq, cfg)
        heat_u = s.heat[torch.clamp(uniq, min=0).long()]
        sel = policies.select_migrations(
            cfg, uniq, mode_u, retr_u, heat_u, ok_u, s.block_pe[blk_u], knobs=knobs)
        for tgt in (modes.SLC, modes.TLC):
            s = ftl.maybe_migrate_pages(s, sel[tgt], tgt, cfg, faults=fp)

        # ---------------- elastic capacity recovery ----------------
        if cfg.reclaim_enabled:
            cls_rd = hotness.classify(s.heat[torch.clamp(lpns, min=0).long()], cfg.heat)
            hw = rd & (cls_rd >= modes.WARM)
            touched_blk = ops.segment_max(hw.to(torch.int32), blk, cfg.n_blocks) > 0
            s = s._replace(block_cold_age=torch.where(
                touched_blk, 0, s.block_cold_age + 1).to(torch.int32))
            free_frac = ftl.free_block_count(s).float() * ops.recip32(cfg.n_blocks)
            rcfg = reclaim.ReclaimConfig(max_per_pass=cfg.max_conversions_per_chunk)
            if bool(free_frac < rcfg.low_watermark):  # one host sync
                s = _reclaim_pass(s, cfg, free_frac, rcfg, fp)

    # ---------------- GC (fused multi-victim, deficit-aware) ----------------
    s = ftl.gc_step(s, cfg, faults=fp, knobs=knobs)

    # clock follows the busiest die (device saturated under FIO load)
    s = s._replace(clock_ms=torch.maximum(s.clock_ms, s.die_busy_ms.max()))

    if arrival is not None:
        # block the next chunk's arrivals behind this chunk's background
        # work, and let wall time follow real arrivals
        die_avail = die_avail + (s.die_busy_ms - busy_mark)
        s = s._replace(
            die_avail_ms=die_avail,
            chan_avail_ms=chan_avail,
            clock_ms=torch.maximum(
                s.clock_ms,
                torch.maximum(t_arr[-1], torch.maximum(die_avail.max(), chan_avail.max()))),
        )

    # ---------------- observability: per-window chunk series ----------------
    if obs.enabled(cfg):
        s = obs.record_chunk(
            s, cfg, t_ms=s.clock_ms,
            writes=s.n_writes - obs0[0],
            conversions=s.n_conversions.sum() - obs0[1],
            erases=s.n_erases - obs0[2],
            migrated=s.n_migrated_pages - obs0[3],
            reloc=s.n_reloc_pages - obs0[4],
        )

    nonfree = s.block_state != st.FREE
    mode_hist = ops.segment_sum(nonfree.to(torch.int32), s.block_mode, 3)
    y = ChunkMetrics(
        capacity_pages=st.usable_capacity_pages(s, cfg),
        free_blocks=ftl.free_block_count(s),
        mode_hist=mode_hist,
        reads=chunk_reads,
        retries=chunk_retries,
        svc_ms=chunk_svc,
        migrated=s.n_migrated_pages,
        lat_hist=chunk_hist,
        w_lat_hist=chunk_w_hist,
        q_ms=chunk_q,
        chanq_ms=chunk_chanw,
        user_pages=s.n_writes - w_c0,
        reloc_pages=s.n_reloc_pages - r_c0,
    )
    return s, y


def _reclaim_pass(s, cfg, free_frac, rcfg, fp):
    """One demotion pass: per-block residual heat (the max heat over the
    block's valid pages), the demotion victims, and their relocation."""
    page_heat = torch.where(s.p2l >= 0, s.heat[torch.clamp(s.p2l, min=0).long()], 0.0)
    block_heat = torch.clamp(page_heat.reshape(cfg.n_blocks, cfg.slots_per_block).amax(1),
                             min=0.0)
    victims, v_ok, v_tgt = reclaim.score_victims(
        s, cfg, reclaim.DEMOTION, block_heat=block_heat, free_frac=free_frac,
        reclaim_cfg=rcfg)
    return ftl.reclaim_victims(s, victims, v_ok, v_tgt, cfg, faults=fp)


def run(cfg: geometry.SimConfig, trace, has_writes: bool | None = None, *, device=None):
    """Run a full trace on ``device`` (CUDA unless the caller names one).
    ``trace`` is a dict with 'lpn' and 'op' arrays of shape (n_chunks,
    cfg.chunk); an optional 'arrival_ms' array of the same shape switches to
    the open-loop model. Returns (final_state, ChunkMetrics stacked over
    chunks)."""
    device = resolve_device(device)
    if has_writes is None:
        has_writes = bool((np.asarray(trace["op"]) == OP_WRITE).any())
    s = st.init_state(cfg, device=device)
    ys = []
    for req in trace_chunks(trace, device):
        s, y = step_chunk(s, req, cfg, has_writes)
        ys.append(y)
    return s, ChunkMetrics(*[torch.stack(f) for f in zip(*ys)])


def trace_chunks(trace, device) -> list[tuple[torch.Tensor, ...]]:
    """A packed trace as per-chunk requests on ``device``: ``(lpn, op)``
    closed loop, ``(lpn, op, arrival_ms)`` open loop, as int32, int32 and
    float32 (the dtypes the reference's ``jnp.asarray`` gives them), one
    copy to the device per array."""
    dtypes = {"lpn": np.int32, "op": np.int32, "arrival_ms": np.float32}
    xs = [torch.from_numpy(np.ascontiguousarray(trace[k], dt)).to(device)
          for k, dt in dtypes.items() if k in trace]
    return list(zip(*xs))


def summarize(s: st.SSDState, cfg: geometry.SimConfig, threads: int = 4):
    """Headline numbers for the paper's figures, from the state's leaves on
    the host (one copy of each). Every value is JSON-safe: floats and nested
    lists."""
    s = convert.ssd_state_to_numpy(s)
    n_reads = float(s.n_reads)
    # open loop: elapsed time is the last die (or channel) availability
    # clock; closed loop: the busy-time makespan
    makespan_ms = float(
        max(np.max(s.die_busy_ms), np.max(s.chan_busy_ms),
            np.max(s.die_avail_ms), np.max(s.chan_avail_ms))
    )
    mean_lat_ms = float(s.svc_sum_ms) / max(n_reads, 1.0)
    if threads == 1:
        # synchronous single-thread: no inter-die overlap
        iops = 1000.0 / mean_lat_ms if mean_lat_ms > 0 else 0.0
    else:
        iops = n_reads / max(makespan_ms / 1000.0, 1e-9)
    cap = float(st.capacity_gib(s, cfg, xp=np))
    init_cap = cfg.n_blocks * cfg.slots_per_block * cfg.page_bytes / 2**30
    pct = telemetry.percentiles(s.lat_hist)
    wpct = telemetry.percentiles(s.w_lat_hist)
    # ---- endurance / WAF telemetry (DESIGN.md §2E) ----
    user_pages = float(s.n_writes)
    reloc_pages = float(s.n_reloc_pages)
    waf = (user_pages + reloc_pages) / user_pages if user_pages > 0 else 1.0
    block_pe = np.asarray(s.block_pe, np.float64)
    live = ~np.asarray(s.block_bad)
    pe_live = block_pe[live] if live.any() else block_pe
    block_mode_h = np.asarray(s.block_mode)
    pe_mean_by_mode = []
    for m in range(modes.N_MODES):
        sel = live & (block_mode_h == m)
        pe_mean_by_mode.append(float(block_pe[sel].mean()) if sel.any() else 0.0)
    cap_bytes = cap * 2**30
    tbw = modes.tbw_bytes(cap_bytes, modes.RATED_PE[modes.QLC], waf)
    host_bytes_per_day = (user_pages * cfg.page_bytes
                          / max(makespan_ms, 1e-9) * 86_400_000.0)
    # ---- spare pool / degraded-mode accounting (DESIGN.md §2D) ----
    pool_total = int(s.spare_total)
    bounded = pool_total < 2**30  # st.SPARE_UNLIMITED sentinel
    spares_total = float(pool_total) if bounded else -1.0
    spares_remaining = float(s.spare_count) if bounded else -1.0
    qlc_ppb = int(geometry.pages_per_block_host(cfg)[modes.QLC])
    spare_covered_gib = (
        min(float(s.bad_count), float(pool_total)) * qlc_ppb * cfg.page_bytes / 2**30
        if bounded
        else float(s.bad_count) * qlc_ppb * cfg.page_bytes / 2**30
    )
    degraded_flag = 1.0 if bounded and int(s.spare_count) <= 0 else 0.0
    return dict(
        iops=iops,
        mean_read_latency_us=mean_lat_ms * 1000.0,
        read_lat_p50_us=pct[0.5],
        read_lat_p95_us=pct[0.95],
        read_lat_p99_us=pct[0.99],
        read_lat_p999_us=pct[0.999],
        write_lat_p50_us=wpct[0.5],
        write_lat_p95_us=wpct[0.95],
        write_lat_p99_us=wpct[0.99],
        write_lat_p999_us=wpct[0.999],
        read_queue_delay_us=float(s.q_sum_ms) / max(n_reads, 1.0) * 1000.0,
        read_chan_wait_us=float(s.chanq_sum_ms) / max(n_reads, 1.0) * 1000.0,
        retries_per_read=float(s.n_retries) / max(n_reads, 1.0),
        capacity_gib=cap,
        capacity_loss_gib=init_cap - cap,
        migrated_pages=float(s.n_migrated_pages),
        erases=float(s.n_erases),
        conversions=np.asarray(s.n_conversions).tolist(),
        reads=n_reads,
        writes=float(s.n_writes),
        uncorrectable_reads=float(s.n_uncorrectable),
        prog_fails=float(s.n_prog_fails),
        erase_fails=float(s.n_erase_fails),
        dropped_writes=float(s.n_dropped_writes),
        bad_blocks=float(s.bad_count),
        rebuilds=float(s.n_rebuilds),
        data_loss=float(s.n_data_loss),
        degraded_writes=float(s.n_degraded_writes),
        spares_total=spares_total,
        spares_remaining=spares_remaining,
        spare_covered_gib=spare_covered_gib,
        effective_capacity_gib=cap + spare_covered_gib,
        degraded=degraded_flag,
        user_pages=user_pages,
        reloc_pages=reloc_pages,
        waf=waf,
        pe_mean=float(pe_live.mean()),
        pe_variance=float(pe_live.var()),
        pe_max=float(pe_live.max()),
        pe_mean_by_mode=pe_mean_by_mode,
        tbw_gib=tbw / 2**30,
        dwpd=modes.dwpd(host_bytes_per_day, cap_bytes) if user_pages > 0 else 0.0,
        lifetime_years=(modes.lifetime_years(tbw, host_bytes_per_day)
                        if user_pages > 0 else 0.0),
        **obs.summary(s, cfg),
    )
