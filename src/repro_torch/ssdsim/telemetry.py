"""Tail-latency telemetry (DESIGN.md §7.1).

Counterpart of ``repro.ssdsim.telemetry``: a fixed log-spaced histogram of
per-read service latency (16 bins per decade from 8 µs to 80 ms),
accumulated on the device each chunk, and host-side quantile readouts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import ops

LAT_MIN_US = 8.0
BINS_PER_DECADE = 16
N_LAT_BINS = 64


def bin_edges_us() -> np.ndarray:
    """(N_LAT_BINS + 1,) log-spaced bin edges in microseconds."""
    exp = np.arange(N_LAT_BINS + 1, dtype=np.float64) / BINS_PER_DECADE
    return LAT_MIN_US * 10.0**exp


def latency_bin(lat_us):
    """Bin index (int32, clipped) of a latency in microseconds, from
    ``floor(log10(lat / 8) * 16)`` in float32. A latency on a bin edge may
    land one bin over on another backend, whose log10 differs in the last
    bit."""
    lat = torch.clamp(lat_us.float(), min=LAT_MIN_US)
    idx = torch.floor(torch.log10(lat * (1.0 / LAT_MIN_US)) * BINS_PER_DECADE)
    return torch.clamp(idx, 0, N_LAT_BINS - 1).to(torch.int32)


def record(hist, lat_us, mask):
    """``hist`` ((N_LAT_BINS,) f32) with each masked latency counted in its
    bin. Counts are integers in float32, so they add exactly in any order."""
    idx = torch.where(mask, latency_bin(lat_us), N_LAT_BINS)
    return ops.at_add(hist, idx, 1.0)


def quantile_bin(hist, q: float) -> int:
    """Index of the bin containing quantile ``q`` of a count histogram (the
    same ``searchsorted`` and empty-bin advance as :func:`percentiles`); 0
    for an empty histogram."""
    h = np.asarray(hist, np.float64)
    total = h.sum()
    if total <= 0:
        return 0
    cum = np.cumsum(h)
    b = int(np.searchsorted(cum, q * total, side="left"))
    nonempty = np.nonzero(h > 0)[0]
    if b >= N_LAT_BINS or h[b] <= 0:
        later = nonempty[nonempty > b] if b < N_LAT_BINS else nonempty[:0]
        b = int(later[0]) if len(later) else int(nonempty[-1])
    return b


def percentiles(hist, qs=(0.5, 0.95, 0.99, 0.999)) -> dict[float, float]:
    """Latency quantiles (µs) of a host-side count histogram, interpolated
    geometrically inside the selected bin; 0.0 for an empty histogram. A
    target that lands on an empty bin advances to the next non-empty one."""
    h = np.asarray(hist, np.float64)
    total = h.sum()
    edges = bin_edges_us()
    out = {}
    if total <= 0:
        return {q: 0.0 for q in qs}
    cum = np.cumsum(h)
    nonempty = np.nonzero(h > 0)[0]
    for q in qs:
        target = q * total
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= N_LAT_BINS or h[b] <= 0:
            later = nonempty[nonempty > b] if b < N_LAT_BINS else nonempty[:0]
            b = int(later[0]) if len(later) else int(nonempty[-1])
        prev = cum[b - 1] if b > 0 else 0.0
        frac = (target - prev) / h[b]
        frac = min(max(frac, 0.0), 1.0)
        lo, hi = edges[b], edges[b + 1]
        out[q] = float(lo * (hi / lo) ** frac)
    return out
