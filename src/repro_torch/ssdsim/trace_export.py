"""Chrome trace-event export for the observability layer (DESIGN.md §7.4).

Converts the per-chunk instruments (:mod:`ssdsim.obs`) into the Chrome
trace-event JSON format, loadable in Perfetto (ui.perfetto.dev) or
``chrome://tracing``:

- **pid 1 "flash events"** — the resource lattice (DESIGN.md §2C): one
  thread track per die (``die D (chan C)``), one per channel bus
  (``channel C bus``), and a "policy (page-granular)" track. Every decoded
  ring-buffer event becomes a complete ("X") slice named by its trigger
  reason on its block's die track, placed at the event's simulated time
  with a duration *estimated* from the timing-model constants (valid pages
  moved x (read at the event's Eq.-3 retry estimate + program in the
  destination mode), + erase for block-granular relocations); each
  block-granular relocation also drops a companion ``transfer`` slice on
  its die's channel-bus track (pages x ``cfg.transfer_us``), so Perfetto
  shows bus occupancy stacking up under contention. Durations are a
  reconstruction for visual scale — the engine books the exact same
  constants into ``die_busy_ms``/``chan_avail_ms`` but does not retain
  per-event spans.
- **pid 2 "telemetry"** — one counter ("C") track per windowed time series
  (reads, retries, conversions, ...), sampled at each window start.

Everything here is host-side numpy over decoded leaves (``obs.decode_events``
and ``obs.decode_timeseries`` copy the state's tensors to the host), so it
takes a state on any device. Counterpart of ``repro.ssdsim.trace_export``:
the same events in the same order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from repro_torch.core import modes
from repro_torch.ssdsim import geometry, obs

PID_FLASH = 1
PID_TELEMETRY = 2

_READ_US = np.asarray(modes.READ_LATENCY_US, np.float64)
_WRITE_US = np.asarray(modes.WRITE_LATENCY_US, np.float64)
_ERASE_US = np.asarray(modes.ERASE_LATENCY_US, np.float64)


def _event_duration_us(rec: dict) -> float:
    """Reconstruct a relocation's device time from the model constants."""
    frm = min(max(rec["from_mode"], 0), modes.N_MODES - 1)
    to = min(max(rec["to_mode"], 0), modes.N_MODES - 1)
    pages = max(rec["pages"], 0)
    per_page = _READ_US[frm] * (1.0 + max(rec["retry_est"], 0.0)) + _WRITE_US[to]
    dur = pages * per_page
    if rec["block"] >= 0:  # block-granular ops erase the source block
        dur += _ERASE_US[frm]
    return float(max(dur, 1.0))  # keep zero-page events visible


def policy_tid(cfg: geometry.SimConfig) -> int:
    """tid of the page-granular policy track (after dies and channel buses)."""
    return cfg.n_dies + cfg.n_channels


def _metadata(cfg: geometry.SimConfig) -> list[dict]:
    md = [
        dict(ph="M", pid=PID_FLASH, tid=0, name="process_name",
             args={"name": "flash events"}),
        dict(ph="M", pid=PID_TELEMETRY, tid=0, name="process_name",
             args={"name": "telemetry"}),
    ]
    # tid layout mirrors the resource lattice: dies first, then one bus
    # track per channel, then the policy track
    for die in range(cfg.n_dies):
        md.append(dict(ph="M", pid=PID_FLASH, tid=die, name="thread_name",
                       args={"name": f"die {die} (chan {cfg.channel_of_die(die)})"}))
    for chan in range(cfg.n_channels):
        md.append(dict(ph="M", pid=PID_FLASH, tid=cfg.n_dies + chan,
                       name="thread_name",
                       args={"name": f"channel {chan} bus"}))
    md.append(dict(ph="M", pid=PID_FLASH, tid=policy_tid(cfg),
                   name="thread_name",
                   args={"name": "policy (page-granular)"}))
    return md


def chrome_trace(s, cfg: geometry.SimConfig) -> dict:
    """Build the trace document (``{"traceEvents": [...], ...}``)."""
    events = _metadata(cfg)
    body: list[dict] = []

    records, total, dropped = obs.decode_events(s, cfg)
    for rec in records:
        # block-granular events pin to their block's die; page-granular
        # conversions (block == -1) span dies and get the policy track
        block_granular = rec["block"] >= 0
        if block_granular:
            die = int(cfg.die_of_block(rec["block"]))
            tid = die
        else:
            tid = policy_tid(cfg)
        args = dict(
            block=rec["block"],
            from_mode=rec["from_mode_name"],
            to_mode=rec["to_mode_name"],
            pages=rec["pages"],
            retry_est=round(rec["retry_est"], 4),
            conversions=rec["conversions"],
        )
        body.append(
            dict(
                ph="X",
                pid=PID_FLASH,
                tid=int(tid),
                ts=rec["t_ms"] * 1000.0,  # trace ts unit is microseconds
                dur=_event_duration_us(rec),
                name=rec["reason_name"],
                cat="relocation",
                args=args,
            )
        )
        if block_granular and rec["pages"] > 0:
            # companion bus slice: the relocated pages' transfers serialize
            # on the die's channel — visual only, like the die-slice spans
            body.append(
                dict(
                    ph="X",
                    pid=PID_FLASH,
                    tid=cfg.n_dies + int(cfg.channel_of_die(die)),
                    ts=rec["t_ms"] * 1000.0,
                    dur=float(max(rec["pages"] * cfg.transfer_us, 1.0)),
                    name="transfer",
                    cat="transfer",
                    args=dict(block=rec["block"], pages=rec["pages"],
                              reason=rec["reason_name"]),
                )
            )

    ts = obs.decode_timeseries(s, cfg)
    win_ms = np.asarray(ts.get("window_start_ms", np.zeros(0)))
    for name in obs.SERIES_NAMES:
        col = np.asarray(ts.get(name, np.zeros(0)))
        for w in range(len(col)):
            if col[w] == 0 and not (w and col[w - 1]):
                continue  # skip leading/inner all-zero stretches
            body.append(
                dict(
                    ph="C",
                    pid=PID_TELEMETRY,
                    tid=0,
                    ts=float(win_ms[w]) * 1000.0,
                    name=name,
                    args={name: float(col[w])},
                )
            )

    body.sort(key=lambda e: e["ts"])
    return dict(
        traceEvents=events + body,
        displayTimeUnit="ms",
        otherData=dict(
            obs_level=cfg.obs_level,
            events_total=total,
            events_dropped=dropped,
            window_ms=float(cfg.obs_window_ms),
        ),
    )


def write_chrome_trace(s, cfg: geometry.SimConfig, path) -> Path:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(s, cfg)))
    return p
