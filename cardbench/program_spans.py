"""What the per-layer metrics read from the program's own spans and
counters (``repro_torch.spans``, which record while the traced window's
profiler runs): each unit of the window (a training step, a prefill
request) with its spans' seconds by name and its counters."""

from __future__ import annotations


def window_units(r, top: str):
    """The traced window's units: the last ``r.window.units`` units of the
    program's span store, each opened by a ``top`` span. None unless the
    profile's host events hold ``top`` once for each of the window's units
    (a program without spans records none; another run's units in the store
    are not this window's) and the store's last units agree."""
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    n = r.window.units
    if not n or sum(1 for h in r.profile.host if h[2] == top) != n:
        return None
    units = spans.snapshot()[-n:]
    if len(units) != n or any(u["name"] != top for u in units):
        return None
    return units


def ms_per_unit(r, top: str, names, clock: str = "stream_s"):
    """Milliseconds a unit in the spans ``names`` together, on ``clock``
    (``stream_s``: between the spans' CUDA events; ``host_s``: the host's
    clock). None where a unit has none of one of them, or where they took
    no CUDA events (the CPU)."""
    units = window_units(r, top)
    if units is None:
        return None
    total = 0.0
    for u in units:
        for name in names:
            s = u["spans"].get(name)
            if s is None or s[clock] is None:
                return None
            total += s[clock]
    return total * 1e3 / len(units)


def counter_sums(r, top: str, names):
    """Each counter of ``names`` summed over the window's units, or None."""
    units = window_units(r, top)
    if units is None:
        return None
    return [sum(u["counters"].get(name, 0) for u in units) for name in names]
