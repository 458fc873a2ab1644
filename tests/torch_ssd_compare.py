"""The comparison rule the Layer A port is held to: against the JAX
package on the CPU (tests/test_torch_*.py) and, in chip_smoke.py's ``ssd``
phase, the card against the CPU:

- integer leaves of ``SSDState``, integer-valued counters of ``summarize``
  and the integer fields of ``ChunkMetrics``: exact;
- float leaves and float summary values: rtol 1e-5;
- latency histograms: equal totals, with no count moved by more than one
  bin (a latency on a bin edge may land one bin over on another backend).

Needs only numpy and torch. A helper module (not collected: no ``test_``
prefix).
"""

from __future__ import annotations

import numpy as np
import torch

FLOAT_RTOL = 1e-5

# summarize keys whose values are counts (integer-valued floats or lists)
INT_SUMMARY_KEYS = {
    "migrated_pages", "erases", "conversions", "reads", "writes", "uncorrectable_reads",
    "prog_fails", "erase_fails", "dropped_writes", "bad_blocks", "rebuilds", "data_loss",
    "degraded_writes", "spares_total", "spares_remaining", "degraded", "user_pages",
    "reloc_pages", "pe_max", "lat_mode_counts", "conversion_events", "obs_events_total",
    "obs_events_dropped",
}
HIST_LEAVES = {"lat_hist", "w_lat_hist"}


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def within_one_bin(ref, out) -> bool:
    """Equal totals, and ``out`` reachable from ``ref`` by moving each count
    at most one bin: with f_k the net count moved across edge k -> k+1, bin k
    must hold what leaves it to the right (f_k > 0) and to the left
    (f_{k-1} < 0)."""
    ref = np.asarray(ref, np.float64).reshape(-1, np.shape(ref)[-1])
    out = np.asarray(out, np.float64).reshape(ref.shape)
    for a, b in zip(ref, out):
        if a.sum() != b.sum():
            return False
        f = np.cumsum(a) - np.cumsum(b)
        right = np.maximum(f, 0.0)
        left = np.maximum(-np.concatenate([[0.0], f[:-1]]), 0.0)
        if (right + left > a).any():
            return False
    return True


def _close(ref, out, rtol):
    return np.allclose(out, ref, rtol=rtol, atol=0.0, equal_nan=True)


def compare_leaves(names, ref, out, where="", loose=None):
    """Mismatches of ``out`` against ``ref`` (sequences of leaves named by
    ``names``) by the comparison rule; ``loose`` maps a leaf name to an
    (rtol, atol) that replaces its float check. Returns a list of strings,
    empty when all agree."""
    loose = loose or {}
    bad = []
    for name, a, b in zip(names, ref, out):
        a, b = to_numpy(a), to_numpy(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{where}{name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        elif name in HIST_LEAVES:
            if not within_one_bin(a, b):
                bad.append(f"{where}{name}: counts moved by more than one bin")
        elif a.dtype.kind in "iub":
            if not np.array_equal(a, b):
                n = int((a != b).sum())
                bad.append(f"{where}{name}: {n} integer entries differ")
        elif name in loose:
            rtol, atol = loose[name]
            if not np.allclose(b, a, rtol=rtol, atol=atol):
                bad.append(f"{where}{name}: beyond rtol {rtol} atol {atol}")
        elif not _close(a, b, FLOAT_RTOL):
            err = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30))
            bad.append(f"{where}{name}: float rel err {err:.3g}")
    return bad


def compare_summaries(ref: dict, out: dict, loose=None):
    """Mismatches of two ``summarize`` dicts by the comparison rule."""
    loose = loose or {}
    bad = []
    if set(ref) != set(out):
        return [f"keys differ: {sorted(set(ref) ^ set(out))}"]
    for k in ref:
        a = np.asarray(ref[k], np.float64)
        b = np.asarray(out[k], np.float64)
        if k in INT_SUMMARY_KEYS:
            ok = np.array_equal(a, b)
        elif k in loose:
            rtol, atol = loose[k]
            ok = np.allclose(b, a, rtol=rtol, atol=atol)
        else:
            ok = _close(a, b, FLOAT_RTOL)
        if not ok:
            bad.append(f"summary {k}: {a.ravel()[:4]} vs {b.ravel()[:4]}")
    return bad


def lindley_loose(cells):
    """The one named exception to the rule, for open-loop runs under
    ``chan_model="lattice"``: the per-(mode, bin) component sums
    ``obs_lat_comp`` and the summary's ``lat_attrib_us`` are held to rtol
    1e-3 plus 0.1 µs per read in the cell. Each read's channel-wait
    component is the difference of two departure clocks, which two
    frameworks' (or devices') Lindley prefix sums round differently, so each
    lane may differ by about one float32 ulp of a clock of hundreds of
    milliseconds. ``cells`` is the reference's ``obs_lat_mode`` (3, bins)."""
    cells = np.asarray(cells, np.float64)
    return {"obs_lat_comp": (1e-3, 0.1 * cells[:, None, :]),
            "lat_attrib_us": (1e-3, 0.1 * cells.sum(-1)[:, None])}
