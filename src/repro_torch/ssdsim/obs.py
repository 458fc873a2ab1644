"""In-run observability (DESIGN.md §7.4): latency attribution, conversion
event tracing and windowed time-series telemetry.

Counterpart of ``repro.ssdsim.obs``. Three instruments, all fixed-shape
accumulator leaves of :class:`repro_torch.ssdsim.state.SSDState`:

1. per-mode read-latency count histograms (``obs_lat_mode``) and, at
   ``"full"``, per-component µs sums by (mode, latency bin)
   (``obs_lat_comp``): queue / sense / retry / channel wait / transfer /
   rebuild;
2. at ``"full"``, an event ring (``obs_events``, ``obs_ev_count``) written at
   every relocation site, overwrite-oldest with the true total kept;
3. windowed time series (``obs_ts``) by simulated time.

``cfg.obs_level`` "off" runs no observability op and keeps every obs leaf
zero-length. Float sums that take values of unequal size go through one-hot
masks (``ops.segment_sum``), so the card adds them in a fixed order; counts
add exactly in any order. Host-side decoders (numpy, on tensors or numpy
leaves) are at the bottom.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import ops
from repro_torch.core import modes
from repro_torch.ssdsim import geometry, telemetry

LEVELS = ("off", "counters", "full")

COMP_QUEUE = 0
COMP_SENSE = 1
COMP_RETRY = 2
COMP_CHANWAIT = 3
COMP_XFER = 4
COMP_REBUILD = 5
N_COMPONENTS = 6
COMPONENT_NAMES = ("queue", "sense", "retry", "chan_wait", "transfer",
                   "rebuild")

EV_T_MS = 0
EV_BLOCK = 1  # -1 for page-granular conversion events
EV_FROM = 2
EV_TO = 3
EV_REASON = 4
EV_RETRY = 5  # Eq.-3 mean retry estimate over the pages moved
EV_PAGES = 6  # valid pages moved
N_EV_FIELDS = 7

REASON_CONV_PAGE = 0  # policy-triggered page-granular conversion (Fig. 11)
REASON_GC = 1  # fused multi-victim GC relocation
REASON_RECLAIM = 2  # elastic capacity recovery demotion (paper §IV-E)
REASON_CONV_BLOCK = 3  # direct block conversion (ftl.migrate_block API)
REASON_BAD_BLOCK = 4  # erase failure -> bad-block retirement (DESIGN.md §2D)
REASON_NAMES = ("conversion", "gc", "reclaim", "block_conversion",
                "bad_block_retire")

TS_READS = 0
TS_RETRIES = 1
TS_QUEUE_MS = 2
TS_WRITES = 3
TS_CONVERSIONS = 4  # n_conversions increments (pages for page-granular ops)
TS_ERASES = 5
TS_MIGRATED = 6
TS_UNCORR = 7  # uncorrectable reads (ECC recovery events, DESIGN.md §2D)
TS_RELOC = 8  # relocation-programmed pages (WAF numerator, DESIGN.md §2E)
N_SERIES = 9
SERIES_NAMES = (
    "reads", "retries", "queue_ms", "writes", "conversions", "erases",
    "migrated_pages", "uncorrectable", "reloc_pages",
)


def enabled(cfg: geometry.SimConfig) -> bool:
    """Counters or better are being collected."""
    return cfg.obs_level != "off"


def full(cfg: geometry.SimConfig) -> bool:
    """Component decomposition + event ring are being collected."""
    return cfg.obs_level == "full"


def init_leaves(cfg: geometry.SimConfig, device) -> dict:
    """Zero accumulators for ``state.init_state``; zero-length when an
    instrument is off."""
    if cfg.obs_level not in LEVELS:
        raise ValueError(
            f"obs_level must be one of {LEVELS}, got {cfg.obs_level!r}"
        )
    n_mode = modes.N_MODES if enabled(cfg) else 0
    n_full = modes.N_MODES if full(cfg) else 0
    cap = int(cfg.obs_event_capacity) if full(cfg) else 0
    win = int(cfg.obs_windows) if enabled(cfg) else 0
    if full(cfg) and cap < 1:
        raise ValueError("obs_event_capacity must be >= 1 at obs_level='full'")
    if enabled(cfg) and win < 1:
        raise ValueError("obs_windows must be >= 1 when observability is on")
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        obs_lat_mode=torch.zeros((n_mode, telemetry.N_LAT_BINS), **f32),
        obs_lat_comp=torch.zeros((n_full, N_COMPONENTS, telemetry.N_LAT_BINS), **f32),
        obs_events=torch.zeros((cap, N_EV_FIELDS), **f32),
        obs_ev_count=torch.zeros((), dtype=torch.int32, device=device),
        obs_ts=torch.zeros((win, N_SERIES), **f32),
    )


# ------------------------------ in-run hooks -------------------------------


def _window_of(cfg: geometry.SimConfig, t_ms):
    """Window index for a sim time; the last window absorbs overflow."""
    w = torch.floor(t_ms.float() * ops.recip32(cfg.obs_window_ms))
    return torch.clamp(w, 0, int(cfg.obs_windows) - 1).to(torch.int32)


def record_reads(s, cfg: geometry.SimConfig, *, mode, rd, lat_us, queue_us,
                 sense_us, retry_us, chanw_us, xfer_us, retries, t_ms,
                 uncorr=None, rebuild_us=None):
    """Per-read instruments for one chunk (engine read path): ``rd`` masks
    user reads, ``t_ms`` is each lane's sim time for windowing."""
    if not enabled(cfg):
        return s
    nbin = telemetry.N_LAT_BINS
    n_win = int(cfg.obs_windows)
    b = telemetry.latency_bin(lat_us).long()
    m = torch.clamp(mode, 0, modes.N_MODES - 1).long()
    # per-mode count histogram: the bins telemetry.record uses for lat_hist,
    # so summing over modes gives it back exactly
    cell = torch.where(rd, m * nbin + b, modes.N_MODES * nbin)
    lat_mode = ops.at_add(s.obs_lat_mode.reshape(-1), cell, 1.0).reshape(s.obs_lat_mode.shape)

    # time series: reads / retries / queue per window of each read's own time
    w = torch.where(rd, _window_of(cfg, t_ms).long(), n_win)
    series = {TS_READS: torch.ones_like(lat_us, dtype=torch.float32),
              TS_RETRIES: retries.float(),
              TS_QUEUE_MS: queue_us.float() * ops.recip32(1000.0)}
    if uncorr is not None:
        series[TS_UNCORR] = uncorr.float()
    vals = torch.zeros((w.shape[0], N_SERIES), dtype=torch.float32, device=w.device)
    for row, v in series.items():
        vals[:, row] = v
    ts = s.obs_ts + ops.segment_sum(vals, w, n_win)
    s = s._replace(obs_lat_mode=lat_mode, obs_ts=ts)

    if not full(cfg):
        return s
    comps = [queue_us, sense_us, retry_us, chanw_us, xfer_us]
    comps.append(rebuild_us if rebuild_us is not None else torch.zeros_like(queue_us))
    add = ops.segment_sum(torch.stack([c.float() for c in comps], dim=1), cell,
                          modes.N_MODES * nbin)  # (3 * nbin, N_COMPONENTS)
    add = add.reshape(modes.N_MODES, nbin, N_COMPONENTS).permute(0, 2, 1)
    return s._replace(obs_lat_comp=s.obs_lat_comp + add)


def record_chunk(s, cfg: geometry.SimConfig, *, t_ms, writes, conversions,
                 erases, migrated, reloc=None):
    """Chunk-granularity series (background-FTL counter deltas), all in the
    window of the chunk's end-of-step clock."""
    if not enabled(cfg):
        return s
    n_win = int(cfg.obs_windows)
    rows = [(TS_WRITES, writes), (TS_CONVERSIONS, conversions), (TS_ERASES, erases),
            (TS_MIGRATED, migrated)]
    if reloc is not None:
        rows.append((TS_RELOC, reloc))
    vec = torch.zeros((N_SERIES,), dtype=torch.float32, device=s.obs_ts.device)
    for row, v in rows:
        vec[row] = v
    at_w = torch.arange(n_win, device=vec.device) == _window_of(cfg, t_ms)
    return s._replace(obs_ts=s.obs_ts + torch.where(at_w[:, None], vec, 0.0))


def record_events(s, cfg: geometry.SimConfig, *, mask, block, from_mode,
                  to_mode, reason, retry_est, pages):
    """Append ``mask``-ed (K,) event lanes to the ring at ``(obs_ev_count +
    rank) mod capacity`` in lane order; the counter keeps the true total.
    With K <= capacity no two lanes share a slot, so the order of the
    writes does not matter."""
    if not full(cfg):
        return s
    cap = s.obs_events.shape[0]
    if mask.shape[0] > cap:
        raise ValueError(f"{mask.shape[0]} event lanes exceed the ring's {cap} slots")
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    pos = (s.obs_ev_count + rank) % cap
    idx = torch.where(mask, pos, cap)
    fields = (s.clock_ms, block, from_mode, to_mode, reason, retry_est, pages)
    rows = torch.stack(
        [torch.as_tensor(v, device=mask.device).float().broadcast_to(mask.shape)
         if isinstance(v, torch.Tensor)
         else torch.full(mask.shape, float(v), dtype=torch.float32, device=mask.device)
         for v in fields], dim=-1)
    return s._replace(
        obs_events=ops.at_set(s.obs_events, idx, rows),
        obs_ev_count=s.obs_ev_count + mask.sum().to(torch.int32),
    )


# ----------------------------- host decoders -------------------------------


def _np(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def decode_events(s, cfg: geometry.SimConfig):
    """Decode the ring into records, oldest first: ``(records, total,
    dropped)``."""
    ev = _np(s.obs_events, np.float32)
    total = int(_np(s.obs_ev_count))
    cap = ev.shape[0]
    if cap == 0 or total == 0:
        return [], total, total
    n = min(total, cap)
    start = total % cap if total > cap else 0
    order = (start + np.arange(n)) % cap
    records = []
    for row in ev[order]:
        reason = int(row[EV_REASON])
        records.append(
            dict(
                t_ms=float(row[EV_T_MS]),
                block=int(row[EV_BLOCK]),
                from_mode=int(row[EV_FROM]),
                to_mode=int(row[EV_TO]),
                from_mode_name=modes.MODE_NAMES[int(row[EV_FROM])],
                to_mode_name=modes.MODE_NAMES[int(row[EV_TO])],
                reason=reason,
                reason_name=REASON_NAMES[reason],
                retry_est=float(row[EV_RETRY]),
                pages=int(row[EV_PAGES]),
                conversions=int(row[EV_PAGES]) if reason == REASON_CONV_PAGE
                else 1,
            )
        )
    return records, total, total - n


def event_conversion_matrix(records) -> np.ndarray:
    """(3, 3) from-mode x to-mode conversion counts from decoded events."""
    m = np.zeros((modes.N_MODES, modes.N_MODES), np.float64)
    for r in records:
        m[r["from_mode"], r["to_mode"]] += r["conversions"]
    return m


def decode_timeseries(s, cfg: geometry.SimConfig) -> dict:
    """Windowed series as a dict of numpy arrays (+ derived means)."""
    ts = _np(s.obs_ts, np.float64)
    out = {"window_start_ms": np.arange(ts.shape[0]) * cfg.obs_window_ms,
           "window_ms": float(cfg.obs_window_ms)}
    for i, name in enumerate(SERIES_NAMES):
        out[name] = ts[:, i]
    reads = np.maximum(out["reads"], 1.0)
    out["mean_queue_delay_us"] = out["queue_ms"] / reads * 1e3
    out["retries_per_read"] = out["retries"] / reads
    writes = out["writes"]
    out["waf_window"] = np.where(
        writes > 0,
        (writes + out["reloc_pages"]) / np.maximum(writes, 1.0),
        1.0,
    )
    return out


def decomposition(s, cfg: geometry.SimConfig) -> dict:
    """Per-mode latency decomposition: read counts and per-component µs per
    latency bin, plus the telemetry bin edges."""
    return dict(
        counts=_np(s.obs_lat_mode, np.float64),
        component_us=_np(s.obs_lat_comp, np.float64),
        edges_us=telemetry.bin_edges_us(),
        components=COMPONENT_NAMES,
        modes=modes.MODE_NAMES,
    )


def tail_attribution(s, cfg: geometry.SimConfig, q: float = 0.99) -> dict:
    """Component shares of the latency mass at and above each mode's
    q-quantile bin."""
    counts = _np(s.obs_lat_mode, np.float64)
    comp = _np(s.obs_lat_comp, np.float64)
    out = {}
    for m, name in enumerate(modes.MODE_NAMES):
        if counts.shape[0] == 0 or counts[m].sum() <= 0:
            out[name] = dict(
                tail_reads=0.0, tail_edge_us=0.0,
                component_us={c: 0.0 for c in COMPONENT_NAMES},
                component_share={c: 0.0 for c in COMPONENT_NAMES},
            )
            continue
        b = telemetry.quantile_bin(counts[m], q)
        tail_us = comp[m, :, b:].sum(axis=1) if comp.shape[0] else np.zeros(
            N_COMPONENTS
        )
        total = max(tail_us.sum(), 1e-12)
        out[name] = dict(
            tail_reads=float(counts[m, b:].sum()),
            tail_edge_us=float(telemetry.bin_edges_us()[b]),
            component_us={c: float(v)
                          for c, v in zip(COMPONENT_NAMES, tail_us)},
            component_share={c: float(v / total)
                             for c, v in zip(COMPONENT_NAMES, tail_us)},
        )
    return out


def summary(s, cfg: geometry.SimConfig) -> dict:
    """JSON-safe flat additions for ``engine.summarize`` (floats and nested
    lists only): ``lat_mode_counts`` from ``counters`` up; ``lat_attrib_us``,
    ``tail_retry_share``, ``conversion_events``, ``obs_events_total`` and
    ``obs_events_dropped`` at ``full``."""
    if not enabled(cfg):
        return {}
    out = {"lat_mode_counts": _np(s.obs_lat_mode, np.float64).tolist()}
    if not full(cfg):
        return out
    comp = _np(s.obs_lat_comp, np.float64)
    attrib = tail_attribution(s, cfg)
    records, total, dropped = decode_events(s, cfg)
    out.update(
        lat_attrib_us=comp.sum(axis=2).tolist(),
        tail_retry_share=[
            attrib[name]["component_share"]["retry"]
            for name in modes.MODE_NAMES
        ],
        conversion_events=event_conversion_matrix(records).tolist(),
        obs_events_total=float(total),
        obs_events_dropped=float(dropped),
    )
    return out
