"""Single FTL passes of the port (repro_torch.ssdsim.ftl) against the JAX
package's on the same mid-run states: each state comes from one JAX engine
run (RARO with conversions, GC and open blocks), is carried across with
``convert.ssd_state_from_numpy``, and both frameworks run one pass on it;
the reference's pass is jitted, as the engine always runs it.
``check_invariants`` runs on the port's state after each pass.

Tolerance (the comparison rule): integer leaves exact, float leaves rtol
1e-5, latency histograms within one bin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ssd_parity import compare_leaves, port_config

from repro.core import faults as j_flt
from repro.core import modes as j_modes
from repro.core import reclaim as j_rec
from repro.ssdsim import engine as j_eng
from repro.ssdsim import ftl as j_ftl
from repro.ssdsim import geometry as j_geo
from repro.ssdsim import obs as j_obs
from repro.ssdsim import state as j_st
from repro.ssdsim import workload as j_wl
from repro_torch import convert
from repro_torch.core import faults, reclaim
from repro_torch.ssdsim import ftl, geometry, obs, state as st

BASE = dict(policy=j_geo.RARO, initial_pe=500, device_age_h=24.0, n_logical=2944,
            gc_free_threshold=12, gc_victims_per_pass=3, obs_level="full",
            obs_event_capacity=512)


@pytest.fixture(scope="module")
def mid_run():
    """The reference's state after 8 chunks of a mixed trace that converts
    pages, fills blocks and fires GC (one JAX run, shared by every test)."""
    cfg = j_geo.tiny_config(**BASE)
    trace = j_wl.mixed_trace(cfg, 128 * 8, 1.2, read_frac=0.7, write_theta=2.0, seed=2)
    s, _ = j_eng.run(cfg, trace)
    leaves = [np.asarray(x) for x in s]
    assert float(s.n_erases) > 0 and float(s.n_migrated_pages) > 0
    return cfg, leaves


def _states(leaves, **replace):
    js = j_st.SSDState(*[jnp.asarray(x) for x in leaves])._replace(
        **{k: jnp.asarray(v) for k, v in replace.items()})
    ts = convert.ssd_state_from_numpy([np.asarray(x) for x in js], device="cpu")
    return js, ts


def _configs(j_cfg, **kw):
    j_cfg = dataclasses.replace(j_cfg, **kw)
    return j_cfg, port_config(j_cfg, geometry)


def _check(js, ts, t_cfg, where):
    bad = compare_leaves(j_st.SSDState._fields, js, ts, where=f"{where}: ")
    assert not bad, "\n".join(bad)
    st.check_invariants(ts, t_cfg, where)


def _victims(js, j_cfg, k, objective="min_valid"):
    v, ok, _ = jax.jit(lambda s: j_rec.score_victims(s, j_cfg, objective, k=k))(js)
    return np.asarray(v), np.asarray(ok)


def _fault_params(j_cfg, t_cfg):
    return j_flt.params_for(j_cfg), faults.params_for(t_cfg, device="cpu")


FAULTS = dict(prog_fail_rate=0.05, erase_fail_rate=0.3, read_fail_rate=0.05,
              max_read_retries=6, parity_rebuild=True, spare_blocks=2, fault_seed=4)


@pytest.mark.parametrize("case", ["gc_same_mode", "convert_to_tlc", "masked_lane",
                                  "faults", "lattice_planes"])
def test_relocate_group(mid_run, case):
    j_cfg, leaves = mid_run
    kw = {"faults": FAULTS, "lattice_planes": dict(chan_model="lattice", planes_per_lun=2,
                                                   blocks_per_plane=8)}.get(case, {})
    j_cfg, t_cfg = _configs(j_cfg, **kw)
    js, ts = _states(leaves)
    victims, ok = _victims(js, j_cfg, 3)
    assert ok.all()
    grp = ok.copy()
    if case == "masked_lane":
        grp[1] = False
    tgt = j_modes.TLC if case == "convert_to_tlc" else int(np.asarray(js.block_mode)[victims[0]])
    jp, tp = _fault_params(j_cfg, t_cfg) if case == "faults" else (None, None)
    # destinations enough for every valid page (the callers' guarantee): 3
    # victims into their own mode need 4; 3 full QLC blocks into TLC, 5
    n_dest = 5 if case == "convert_to_tlc" else 4
    ref = jax.jit(lambda s, v, g: j_ftl.relocate_group(
        s, v, g, tgt, j_cfg, n_dest, reason=j_obs.REASON_GC, faults=jp))(js, victims, grp)
    out = ftl.relocate_group(ts, torch.tensor(victims), torch.tensor(grp), tgt, t_cfg,
                             n_dest, reason=obs.REASON_GC, faults=tp)
    _check(ref, out, t_cfg, f"relocate_group {case}")
    assert float(out.n_erases) > float(ts.n_erases)


def test_migrate_block_with_tensor_target(mid_run):
    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg)
    js, ts = _states(leaves)
    victims, _ = _victims(js, j_cfg, 1)
    tgt = np.int32(j_modes.SLC)
    ref = jax.jit(lambda s, v, t: j_ftl.migrate_block(s, v, t, j_cfg))(js, victims[0], tgt)
    out = ftl.migrate_block(ts, int(victims[0]), torch.tensor(tgt), t_cfg)
    _check(ref, out, t_cfg, "migrate_block")


def _hot_lpns(js, n):
    """The n hottest mapped logical pages (some already in the target mode,
    which the pass must skip), -1-padded to n + 3 lanes."""
    heat = np.asarray(js.heat)
    l2p = np.asarray(js.l2p)
    order = np.argsort(-heat, kind="stable")
    lp = order[l2p[order] >= 0][:n].astype(np.int32)
    return np.concatenate([lp, np.full(3, -1, np.int32)])


@pytest.mark.parametrize("tgt", [j_modes.SLC, j_modes.TLC])
@pytest.mark.parametrize("armed", [False, True])
def test_migrate_pages(mid_run, tgt, armed):
    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg, **(FAULTS if armed else {}))
    js, ts = _states(leaves)
    lpns = _hot_lpns(js, j_cfg.migrate_pages_per_chunk - 3)
    jp, tp = _fault_params(j_cfg, t_cfg) if armed else (None, None)
    ref = jax.jit(lambda s, lp: j_ftl.maybe_migrate_pages(s, lp, tgt, j_cfg, faults=jp))(
        js, lpns)
    out = ftl.maybe_migrate_pages(ts, torch.tensor(lpns), tgt, t_cfg, faults=tp)
    _check(ref, out, t_cfg, f"migrate_pages -> {tgt}")
    assert float(out.n_migrated_pages) > float(ts.n_migrated_pages)


def test_maybe_migrate_pages_gate_is_a_no_op(mid_run):
    j_cfg, leaves = mid_run
    t_cfg = port_config(j_cfg, geometry)
    _, ts = _states(leaves)
    out = ftl.maybe_migrate_pages(ts, torch.full((16,), -1, dtype=torch.int32), 0, t_cfg)
    assert out is ts


def _demotion_state(leaves, j_cfg):
    """The mid-run state with every block cold for 5 epochs (so the
    converted SLC/TLC blocks are demotion candidates)."""
    age = np.full(j_cfg.n_blocks, 5, np.int32)
    return _states(leaves, block_cold_age=age)


def test_reclaim_victims(mid_run):
    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg)
    js, ts = _demotion_state(leaves, j_cfg)
    heat = np.zeros(j_cfg.n_blocks, np.float32)
    rc = j_rec.ReclaimConfig(max_per_pass=j_cfg.max_conversions_per_chunk)
    v, ok, tgt = jax.jit(lambda s: j_rec.score_victims(
        s, j_cfg, j_rec.DEMOTION, block_heat=heat, free_frac=0.05, reclaim_cfg=rc))(js)
    assert np.asarray(ok).any()
    ref = jax.jit(lambda s, a, b, c: j_ftl.reclaim_victims(s, a, b, c, j_cfg))(js, v, ok, tgt)
    tv, tok, ttgt = reclaim.score_victims(ts, t_cfg, reclaim.DEMOTION,
                                          block_heat=torch.from_numpy(heat), free_frac=0.05,
                                          reclaim_cfg=reclaim.ReclaimConfig(*rc))
    out = ftl.reclaim_victims(ts, tv, tok, ttgt, t_cfg)
    _check(ref, out, t_cfg, "reclaim_victims")
    assert np.asarray(out.n_conversions)[:, 1:].sum() > np.asarray(ts.n_conversions)[:, 1:].sum()


@pytest.mark.parametrize("case", ["min_valid", "lifespan", "knob_lifespan", "faults"])
def test_gc_step(mid_run, case):
    j_cfg, leaves = mid_run
    kw = dict(gc_free_threshold=int(leaves[j_st.SSDState._fields.index("free_count")]) + 2)
    if case == "lifespan":
        kw["gc_objective"] = "lifespan"
    if case == "faults":
        kw.update(FAULTS)
    j_cfg, t_cfg = _configs(j_cfg, **kw)
    js, ts = _states(leaves)
    jp, tp = _fault_params(j_cfg, t_cfg) if case == "faults" else (None, None)
    knobs = None
    if case == "knob_lifespan":
        from repro.ssdsim import policies as j_pol
        from repro_torch.ssdsim import policies

        knobs = (j_pol.RunKnobs(1, -1, 500, gc_objective=jnp.int32(1)),
                 policies.RunKnobs(1, -1, 500, gc_objective=torch.tensor(1)))
    ref = jax.jit(lambda s: j_ftl.gc_step(s, j_cfg, faults=jp,
                                          knobs=knobs and knobs[0]))(js)
    out = ftl.gc_step(ts, t_cfg, faults=tp, knobs=knobs and knobs[1])
    _check(ref, out, t_cfg, f"gc_step {case}")
    assert float(out.n_erases) > float(ts.n_erases)


@pytest.mark.parametrize("policy", ["lowest_id", "youngest"])
def test_alloc_free_block(mid_run, policy):
    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg, alloc_policy=policy)
    rng = np.random.default_rng(0)
    pe = rng.integers(400, 600, j_cfg.n_blocks).astype(np.int32)
    # a stale hint (a consumed block) on die 1, a dead one on die 2
    js, ts = _states(leaves, block_pe=pe)
    hints = np.asarray(js.free_hint).copy()
    hints[1] = int(np.nonzero(np.asarray(js.block_state) == st.FULL)[0][1])
    hints[2] = -1
    js, ts = _states([np.asarray(x) for x in js], free_hint=hints)
    for lun in [None, 0, 1, 2, 3]:
        ref = jax.jit(lambda s: j_ftl.alloc_free_block(s, prefer_lun=lun, cfg=j_cfg))(js)
        out = ftl.alloc_free_block(ts, prefer_lun=lun, cfg=t_cfg)
        assert out.dtype == torch.int32
        assert int(out) == int(ref), (policy, lun)


def test_erase_many_with_faults(mid_run):
    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg, **FAULTS)
    js, ts = _states(leaves)
    victims, ok = _victims(js, j_cfg, 6)
    jp, tp = _fault_params(j_cfg, t_cfg)
    ref = jax.jit(lambda s, v, g: j_ftl.relocate_group(s, v, g, 2, j_cfg, 8, faults=jp))(
        js, victims, ok)
    out = ftl.relocate_group(ts, torch.tensor(victims), torch.tensor(ok), 2, t_cfg, 8,
                             faults=tp)
    _check(ref, out, t_cfg, "relocate + erase with faults")
    assert float(out.n_erase_fails) > 0 and int(out.bad_count) > 0
    assert int(out.spare_count) == max(int(out.spare_total) - int(out.bad_count), 0)


@pytest.mark.parametrize("which", ["table_iii", "tiny"])
def test_reference_gc_cannot_fire_at_default_thresholds(mid_run, which):
    """Pins a fault of the reference (ROADMAP queue 3): GC fires only below
    ``gc_free_threshold`` free blocks but relocates only with at least
    ``MAX_DEST + (k - 1) + 2`` free, and at both ``SimConfig()`` (8 against
    5 + 3 + 2) and ``tiny_config()`` (2 against 5 + 1 + 2) no free count
    meets both, so GC never relocates at the defaults. The port keeps it."""
    j_cfg = j_geo.SimConfig() if which == "table_iii" else j_geo.tiny_config()
    k = j_cfg.gc_victims_per_pass
    assert j_cfg.gc_free_threshold <= j_ftl._gc_dest_need(j_cfg, k) + 2
    assert ftl._gc_dest_need(port_config(j_cfg, geometry), k) == j_ftl._gc_dest_need(j_cfg, k)
    # on the mid-run state (reclaimable victims), every free count below
    # the threshold leaves the state as it was, in both frameworks
    j_cfg, t_cfg = _configs(mid_run[0], gc_free_threshold=j_cfg.gc_free_threshold,
                            gc_victims_per_pass=k)
    gc_step = jax.jit(lambda s: j_ftl.gc_step(s, j_cfg))
    for free in range(j_cfg.gc_free_threshold):
        js, ts = _states(mid_run[1], free_count=np.int32(free))
        ref = gc_step(js)
        assert float(ref.n_erases) == float(js.n_erases)
        assert ftl.gc_step(ts, t_cfg) is ts


def test_event_ring_refuses_more_lanes_than_slots(mid_run):
    """More event lanes than ring slots: the reference's ring scatter writes
    two lanes to one slot, and its docstring promises the most recent
    ``capacity`` events. The port writes only the last ``capacity`` masked
    lanes, so the ring holds the same events as the reference's, whose
    scatter on the CPU lets the later lane win."""
    from repro.ssdsim import obs as j_obs

    j_cfg, leaves = mid_run
    j_cfg, t_cfg = _configs(j_cfg, obs_event_capacity=2)
    js, ts = _states(leaves, obs_events=np.zeros((2, obs.N_EV_FIELDS), np.float32))
    mask = np.array([True, False, True, True, True])
    pages = np.arange(5, dtype=np.float32)
    kw = dict(from_mode=0, to_mode=1, reason=obs.REASON_GC)
    js = j_obs.record_events(js, j_cfg, mask=jnp.asarray(mask), block=jnp.asarray(pages),
                             retry_est=jnp.zeros(5), pages=jnp.asarray(pages), **kw)
    ts = obs.record_events(ts, t_cfg, mask=torch.tensor(mask), block=torch.tensor(pages),
                           retry_est=torch.zeros(5), pages=torch.tensor(pages), **kw)
    np.testing.assert_array_equal(ts.obs_events.numpy(), np.asarray(js.obs_events))
    assert int(ts.obs_ev_count) == int(js.obs_ev_count)
    records, total, dropped = obs.decode_events(ts, t_cfg)
    assert [r["pages"] for r in records] == [3, 4] and dropped == total - 2


@pytest.mark.parametrize("case", ["plain", "faults", "degraded"])
def test_write_path_batched(mid_run, case):
    """One chunk of the engine's batched write path on the mid-run state:
    duplicate LPNs in the chunk, open-block rollovers, and with faults the
    re-placement of failed programs (or, with the spare pool run dry, the
    read-only degraded mode)."""
    from repro.ssdsim import engine as j_engine
    from repro_torch.ssdsim import engine

    j_cfg, leaves = mid_run
    kw = dict(FAULTS, prog_fail_rate=0.2) if case != "plain" else {}
    j_cfg, t_cfg = _configs(j_cfg, **kw)
    replace = dict(spare_count=np.int32(0), spare_total=np.int32(2),
                   bad_count=np.int32(2)) if case == "degraded" else {}
    if case == "degraded":  # two retired blocks, consistent with the pool
        bad = np.zeros(j_cfg.n_blocks, bool)
        free = np.nonzero(np.asarray(leaves[j_st.SSDState._fields.index("block_state")]) == 0)
        bad[free[0][-2:]] = True
        state = np.where(bad, st.BAD, leaves[j_st.SSDState._fields.index("block_state")])
        replace.update(block_bad=bad, block_state=state.astype(np.int32),
                       free_count=np.int32(int((state == st.FREE).sum())))
    js, ts = _states(leaves, **replace)
    rng = np.random.default_rng(1)
    C = j_cfg.chunk
    lpns = rng.integers(0, j_cfg.n_logical, C).astype(np.int32)
    lpns[:10] = lpns[10:20]  # duplicates within the chunk
    lpns[-3:] = -1  # padding lanes
    is_write = rng.random(C) < 0.8
    jp, tp = _fault_params(j_cfg, t_cfg) if kw.get("prog_fail_rate") else (None, None)
    ref = jax.jit(lambda s, lp, w: j_engine.write_path_batched(s, lp, w, j_cfg, faults=jp))(
        js, lpns, is_write)
    out = engine.write_path_batched(ts, torch.tensor(lpns), torch.tensor(is_write), t_cfg,
                                    faults=tp)
    _check(ref, out, t_cfg, f"write_path_batched {case}")
    if case == "faults":
        assert float(out.n_prog_fails) > 0
    if case == "degraded":
        assert float(out.n_degraded_writes) > 0 and float(out.n_writes) == float(ts.n_writes)
