"""Helpers of the Layer A parity tests: the port's config from the
reference's, and the end-to-end engine cases that ``test_torch_engine.py``
and ``test_torch_engine_open.py`` share, checked by the comparison rule of
``torch_ssd_compare``. Not collected (no ``test_`` prefix).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch_ssd_compare import (  # noqa: F401  (re-exported to the tests)
    FLOAT_RTOL, compare_leaves, compare_summaries, lindley_loose, to_numpy, within_one_bin)


def port_config(ref_cfg, port_geometry):
    """The port's SimConfig with every field of the reference's."""
    from repro_torch.core import hotness

    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["heat"] = hotness.HeatConfig(*fields["heat"])
    return port_geometry.SimConfig(**fields)


# ---------------------------------------------------------------------------
# engine.run + summarize end to end, the cases of test_torch_engine*.py
# ---------------------------------------------------------------------------

def _engine_modules():
    from repro.ssdsim import engine as j_eng
    from repro.ssdsim import geometry as j_geo
    from repro.ssdsim import policies as j_pol
    from repro.ssdsim import state as j_st
    from repro_torch.ssdsim import engine, geometry, policies, state as st, workload

    return j_eng, j_geo, j_pol, j_st, engine, geometry, policies, st, workload


def engine_cases():
    """name -> (reference config, (trace kind, chunks), knobs or None)."""
    j_geo = _engine_modules()[1]
    T = j_geo.tiny_config
    aged = dict(initial_pe=500, device_age_h=24.0)
    gc = dict(n_logical=2944, gc_free_threshold=18, gc_victims_per_pass=4)
    return {
        "baseline": (T(policy=j_geo.BASELINE, **aged), ("zipf", 16), None),
        "hotness": (T(policy=j_geo.HOTNESS, **aged), ("zipf", 16), None),
        # RARO converting hot pages until GC and reclaim demotion fire, with
        # every observability instrument on
        "raro_gc_reclaim_obs_full": (
            T(policy=j_geo.RARO, n_logical=2944, gc_free_threshold=12, gc_victims_per_pass=1,
              obs_level="full", obs_event_capacity=512, **aged), ("zipf", 40), None),
        "mixed_gc": (T(policy=j_geo.RARO, obs_level="counters", **gc, **aged), ("mixed", 24),
                     None),
        "open_legacy": (T(policy=j_geo.RARO, **aged), ("open_zipf", 16), None),
        "open_lattice": (T(policy=j_geo.RARO, chan_model="lattice", obs_level="full", **aged),
                         ("open_mixed", 30), None),
        "faults": (T(policy=j_geo.RARO, initial_pe=833, device_age_h=24.0, prog_fail_rate=0.02,
                     erase_fail_rate=0.05, read_fail_rate=0.01, max_read_retries=10,
                     parity_rebuild=True, spare_blocks=4, gc_objective="lifespan", **gc),
                   ("mixed", 24), None),
        "knobs": (T(policy=j_geo.RARO, **gc, **aged), ("open_mixed", 24),
                  dict(r1=2, r2_override=6, initial_pe=700, arrival_scale=1.5, gc_objective=1)),
    }


def engine_trace(workload, cfg, kind, n_chunks):
    n = cfg.chunk * n_chunks
    if kind == "zipf":
        return workload.zipf_read_trace(cfg, n, 1.2, seed=1)
    if kind == "open_zipf":
        return workload.zipf_read_trace(cfg, n, 1.2, seed=1, arrival_rate=50_000.0)
    if kind == "mixed":
        return workload.mixed_trace(cfg, n, 1.2, read_frac=0.3, write_theta=2.0)
    return workload.mixed_trace(cfg, n, 1.2, read_frac=0.5, write_theta=2.0,
                                arrival_rate=20_000.0)


def run_engine_case(name):
    """Both engines on one case's trace: (name, ref cfg, port cfg, (ref state,
    ref metrics), (port state, port metrics)). With knobs, both run the
    reference sweep runner's path: ``init_state`` seeded from the knobs, then
    ``step_chunk`` over the chunks."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    j_eng, j_geo, j_pol, j_st, engine, geometry, policies, st, workload = _engine_modules()
    j_cfg, (kind, n_chunks), kn = engine_cases()[name]
    t_cfg = port_config(j_cfg, geometry)
    trace = engine_trace(workload, t_cfg, kind, n_chunks)
    if kn is None:
        return name, j_cfg, t_cfg, j_eng.run(j_cfg, trace), engine.run(t_cfg, trace, device="cpu")
    has_writes = bool((trace["op"] == j_eng.OP_WRITE).any())
    xs = tuple(jnp.asarray(trace[k]) for k in ("lpn", "op", "arrival_ms") if k in trace)

    @jax.jit
    def go(xs, knobs):
        s0 = j_st.init_state(j_cfg, initial_pe=knobs.initial_pe, spare_blocks=knobs.spare_blocks)
        return lax.scan(lambda s, x: j_eng.step_chunk(s, x, j_cfg, has_writes, knobs), s0, xs)

    ref = go(xs, j_pol.RunKnobs(**{k: jnp.asarray(v) for k, v in kn.items()}))
    knobs = policies.RunKnobs(**{k: torch.tensor(v) for k, v in kn.items()})
    s = st.init_state(t_cfg, initial_pe=knobs.initial_pe, spare_blocks=knobs.spare_blocks,
                      device="cpu")
    ys = []
    for req in zip(*[torch.tensor(np.asarray(x)) for x in xs]):
        s, y = engine.step_chunk(s, req, t_cfg, has_writes, knobs)
        ys.append(y)
    out = (s, engine.ChunkMetrics(*[torch.stack(f) for f in zip(*ys)]))
    return name, j_cfg, t_cfg, ref, out


def _loose(name, cells):
    """The lattice exception of the rule (``lindley_loose``) for the one
    open-loop lattice case."""
    return lindley_loose(cells) if name == "open_lattice" else {}


def check_engine_state(case):
    name, j_cfg, t_cfg, (js, _), (ts, _) = case
    j_st, st = _engine_modules()[3], _engine_modules()[7]
    st.check_invariants(ts, t_cfg, name)
    loose = {k: v for k, v in _loose(name, np.asarray(js.obs_lat_mode)).items()
             if k in j_st.SSDState._fields}
    bad = compare_leaves(j_st.SSDState._fields, js, ts, where=f"{name}: ", loose=loose)
    assert not bad, "\n".join(bad)


def check_engine_summary(case):
    name, j_cfg, t_cfg, (js, _), (ts, _) = case
    j_eng, engine = _engine_modules()[0], _engine_modules()[4]
    ref, out = j_eng.summarize(js, j_cfg), engine.summarize(ts, t_cfg)
    bad = compare_summaries(ref, out, loose=_loose(name, np.asarray(js.obs_lat_mode)))
    assert not bad, "\n".join(bad)


def check_engine_metrics(case):
    name, j_cfg, t_cfg, (_, jm), (_, tm) = case
    j_eng = _engine_modules()[0]
    bad = compare_leaves(j_eng.ChunkMetrics._fields, jm, tm, where=f"{name} metrics: ")
    assert not bad, "\n".join(bad)


# what each case is there for, so that its parity is not vacuous
ENGINE_CASE_REACHES = {
    "baseline": lambda s, ts: s["migrated_pages"] == 0 and s["retries_per_read"] > 0,
    "hotness": lambda s, ts: s["migrated_pages"] > 0,
    "raro_gc_reclaim_obs_full": lambda s, ts: (
        s["erases"] > 0 and s["obs_events_total"] > 0
        and np.asarray(ts.n_conversions)[:2, 1:].sum() > 0),
    "mixed_gc": lambda s, ts: s["erases"] > 0 and s["waf"] > 1.0,
    "open_legacy": lambda s, ts: s["read_queue_delay_us"] > 0,
    "open_lattice": lambda s, ts: s["read_chan_wait_us"] > 0 and s["writes"] > 0,
    "faults": lambda s, ts: (s["erases"] > 0 and s["prog_fails"] > 0 and s["bad_blocks"] > 0
                             and s["uncorrectable_reads"] > 0 and s["rebuilds"] > 0),
    "knobs": lambda s, ts: s["migrated_pages"] > 0 and int(ts.block_pe.min()) >= 700,
}


def check_engine_reaches(case):
    name, j_cfg, t_cfg, _, (ts, _) = case
    s = _engine_modules()[4].summarize(ts, t_cfg)
    assert ENGINE_CASE_REACHES[name](s, ts), (
        name, {k: s[k] for k in ("migrated_pages", "erases", "writes")})
