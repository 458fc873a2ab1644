"""The port's Chrome trace export (``repro_torch.ssdsim.trace_export``): the
twins of ``tests/test_obs.py``'s two trace-export tests on a ``tiny_config``
run of the port, and the port's ``chrome_trace`` against the JAX package's on
the same run of each engine: the same events in the same order, integer
fields and names equal, float fields (times, durations, counter values,
retry estimates) within rtol 1e-5, as ``tests/torch_ssd_compare.py``'s rule
holds floats.
"""

import json

import numpy as np
import pytest

from repro_torch.ssdsim import engine, geometry, obs, trace_export, workload

FLOAT_KEYS = {"ts", "dur", "retry_est", "window_ms"}


def _full_cfg(g, **kw):
    base = dict(policy=g.RARO, initial_pe=500, obs_level="full",
                obs_event_capacity=4096, obs_windows=32, obs_window_ms=5.0)
    base.update(kw)
    return g.tiny_config(**base)


@pytest.fixture(scope="module")
def mixed_run():
    """One tiny mixed closed-loop run of the port with every instrument on."""
    cfg = _full_cfg(geometry)
    tr = workload.mixed_trace(cfg, 16 * cfg.chunk, theta=1.0, read_frac=0.7, seed=3)
    s, _ = engine.run(cfg, tr, device="cpu")
    return cfg, s, tr


def test_schema(mixed_run, tmp_path):
    cfg, s, _ = mixed_run
    p = trace_export.write_chrome_trace(s, cfg, tmp_path / "trace.json")
    doc = json.loads(p.read_text())
    evs = doc["traceEvents"]
    body = [e for e in evs if e["ph"] != "M"]
    assert body, "trace has no events"
    # required keys + sane values per phase
    for e in evs:
        assert e["ph"] in ("M", "X", "C")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] > 0
            assert e["pid"] == trace_export.PID_FLASH
            assert 0 <= e["tid"] <= trace_export.policy_tid(cfg)
        if e["ph"] == "C":
            assert e["pid"] == trace_export.PID_TELEMETRY
    ts = [e["ts"] for e in body]
    assert all(a <= b for a, b in zip(ts, ts[1:])), "ts not monotone"
    # the lattice tracks: one per die, one bus per channel, plus the
    # page-granular policy track
    names = {
        e["args"]["name"] for e in evs
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    assert {
        f"die {d} (chan {cfg.channel_of_die(d)})"
        for d in range(cfg.n_dies)
    } <= names
    assert {f"channel {c} bus" for c in range(cfg.n_channels)} <= names
    assert "policy (page-granular)" in names


def test_event_slices_match_ring(mixed_run):
    cfg, s, _ = mixed_run
    doc = trace_export.chrome_trace(s, cfg)
    records, total, _ = obs.decode_events(s, cfg)
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    reloc = [e for e in x if e["cat"] == "relocation"]
    xfer = [e for e in x if e["cat"] == "transfer"]
    assert len(reloc) == len(records)
    # each block-granular relocation with pages moved gets a companion
    # transfer slice on its die's channel-bus track
    assert len(xfer) == sum(
        1 for r in records if r["block"] >= 0 and r["pages"] > 0
    )
    for e in xfer:
        assert cfg.n_dies <= e["tid"] < cfg.n_dies + cfg.n_channels
    assert doc["otherData"]["events_total"] == total


def _same(a, b, path=""):
    """Mismatches of the port's trace document ``b`` against the reference's
    ``a``: equal structure, floats of ``FLOAT_KEYS`` and counter values
    within rtol 1e-5, everything else equal."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [m for k in a for m in _same(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [f"{path}: {len(a)} vs {len(b)} entries"]
        return [m for i, (x, y) in enumerate(zip(a, b)) for m in _same(x, y, f"{path}[{i}]")]
    if isinstance(a, float) and not float(a).is_integer() or path.rsplit(".", 1)[-1] in FLOAT_KEYS:
        ok = np.isclose(b, a, rtol=1e-5, atol=0.0)
    else:
        ok = a == b and type(a) is type(b)
    return [] if ok else [f"{path}: {a!r} vs {b!r}"]


def test_chrome_trace_matches_reference(mixed_run):
    from repro.ssdsim import engine as j_eng
    from repro.ssdsim import geometry as j_geo
    from repro.ssdsim import trace_export as j_te

    cfg, s, tr = mixed_run
    j_cfg = _full_cfg(j_geo)
    js, _ = j_eng.run(j_cfg, tr)
    ref, out = j_te.chrome_trace(js, j_cfg), trace_export.chrome_trace(s, cfg)
    # round-trip both through JSON, as write_chrome_trace does
    ref, out = json.loads(json.dumps(ref)), json.loads(json.dumps(out))
    assert sum(e["ph"] == "X" for e in ref["traceEvents"]) > 0
    assert sum(e["ph"] == "C" for e in ref["traceEvents"]) > 0
    bad = _same(ref, out)
    assert not bad, "\n".join(bad[:20])
