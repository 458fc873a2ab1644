"""Block-trace replay (DESIGN.md §7.2).

Replays MSR-Cambridge-style block traces through the simulator. The MSR
format (SNIA IOTTA) is a headerless CSV:

    Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime

with ``Timestamp`` in Windows filetime ticks, ``Type`` in {Read, Write},
``Offset``/``Size`` in bytes and ``ResponseTime`` in microseconds. Each I/O
is expanded into per-page requests (16 KiB simulator pages) and the trace's
byte-address footprint is wrapped onto the simulated LPN space with relative
locality preserved, so hot ranges in the trace stay hot ranges on the
device.

A small bundled sample (``data/msr_sample.csv``, same column layout) keeps
the subsystem testable offline; drop a real ``*.csv`` from the MSR corpus
next to it (or pass an absolute path) to replay production traces.
Counterpart of ``repro.experiments.traces``, with its own copy of the
sample.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from repro_torch.experiments.registry import register
from repro_torch.ssdsim import geometry, workload
from repro_torch.ssdsim.engine import OP_READ, OP_WRITE

DATA_DIR = Path(__file__).parent / "data"
SAMPLE_TRACE = DATA_DIR / "msr_sample.csv"

_READ_ALIASES = {"read", "r", "rs"}
_WRITE_ALIASES = {"write", "w", "ws"}


def parse_msr_csv(path) -> dict[str, np.ndarray]:
    """Parse an MSR-format CSV into ``{timestamp, op, offset, size}`` arrays.

    ``op`` is OP_READ/OP_WRITE, ``offset``/``size`` are int64 bytes. A
    leading header row (non-numeric timestamp) is tolerated and skipped, as
    are malformed/empty lines — real MSR files occasionally contain both.
    """
    ts, op, off, sz = [], [], [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 6:
                continue
            try:
                t = int(row[0])
                o = int(row[4])
                s = int(row[5])
            except ValueError:
                continue  # header or malformed line
            kind = row[3].strip().lower()
            if kind in _READ_ALIASES:
                op.append(OP_READ)
            elif kind in _WRITE_ALIASES:
                op.append(OP_WRITE)
            else:
                continue
            ts.append(t)
            off.append(o)
            sz.append(s)
    if not ts:
        raise ValueError(f"no parseable records in trace {path}")
    return {
        "timestamp": np.asarray(ts, np.int64),
        "op": np.asarray(op, np.int32),
        "offset": np.asarray(off, np.int64),
        "size": np.asarray(sz, np.int64),
    }


def records_to_page_requests(cfg: geometry.SimConfig, rec: dict[str, np.ndarray]):
    """Expand byte-granular I/Os into per-page (lpn, op, arrival_ms) streams.

    Each I/O touches ``ceil(size / page_bytes)`` consecutive pages starting
    at ``offset // page_bytes``; every page of an I/O inherits the I/O's
    arrival time. The trace's page-address range is shifted to start at 0
    and wrapped modulo ``n_logical``: relative locality (and thus
    block-level read-disturb concentration) survives the remap even when the
    traced volume is far larger than the simulated device. Arrival times are
    Windows-filetime ticks (100 ns) rebased to ms from the first record.
    """
    pb = cfg.page_bytes
    first = rec["offset"] // pb
    n_pages = np.maximum(-(-(rec["offset"] % pb + rec["size"]) // pb), 1)
    base = int(first.min())

    lpn = np.repeat(first - base, n_pages)
    # per-request offsets 0..n_pages-1 within each I/O
    cum = np.cumsum(n_pages)
    idx = np.arange(cum[-1], dtype=np.int64)
    idx -= np.repeat(cum - n_pages, n_pages)
    lpn = (lpn + idx) % cfg.n_logical
    op = np.repeat(rec["op"], n_pages)
    ts = rec["timestamp"]
    arrival_ms = np.repeat((ts - ts.min()) / 1e4, n_pages).astype(np.float64)
    return lpn.astype(np.int32), op.astype(np.int32), arrival_ms


def replay_trace(cfg: geometry.SimConfig, path, n_requests: int | None = None,
                 arrivals: bool = True, time_scale: float = 1.0):
    """Full pipeline: CSV -> page requests -> packed engine trace.

    ``n_requests`` truncates (or cycles, if the trace is shorter) the
    request stream so sweep groups can share one static trace shape; cycled
    repetitions are shifted by the trace duration so arrival times stay
    nondecreasing. ``arrivals=False`` drops the timestamp column and replays
    the trace closed-loop (the pre-arrival-model behavior);
    ``time_scale > 1`` compresses the recorded timeline, raising the offered
    load (the sweep runner's ``arrival_scale`` knob does the same per run
    without rebuilding the trace).
    """
    lpn, op, arr = records_to_page_requests(cfg, parse_msr_csv(path))
    if n_requests is not None:
        if len(lpn) < n_requests:  # cycle the trace to fill the budget
            reps = -(-n_requests // len(lpn))
            span = arr[-1] + (arr[-1] - arr[0]) / max(len(arr) - 1, 1)
            arr = np.concatenate([arr + r * span for r in range(reps)])
            lpn = np.tile(lpn, reps)
            op = np.tile(op, reps)
        lpn, op, arr = lpn[:n_requests], op[:n_requests], arr[:n_requests]
    return workload._pack(cfg, lpn, op, arr / time_scale if arrivals else None)


@register("msr_sample", seed_invariant=True)
def msr_sample(cfg: geometry.SimConfig, n_requests: int, seed: int = 0,
               path=None, arrivals: bool = True, time_scale: float = 1.0):
    """Replay of the bundled MSR-style sample trace (seed is unused; trace
    replay is deterministic by construction). Replays open-loop against the
    CSV's timestamp column by default; ``arrivals=False`` restores the
    closed-loop replay."""
    return replay_trace(cfg, path or SAMPLE_TRACE, n_requests=n_requests,
                        arrivals=arrivals, time_scale=time_scale)
