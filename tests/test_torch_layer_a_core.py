"""Parity of the port's Layer A policy and fault core (repro_torch.core:
modes, hotness, policy, retry, controller, faults, reclaim) with
repro.core on the CPU: the same numpy inputs, made from a seed, go through
both.

Tolerances: integer outputs (stages, thresholds, decisions, plans, fault
draws, victim lanes) exact; the fault hash and its float32 uniform draw
bit-exact; float scores exact where the reference's compiled program and
the port round the same way (``demotion_scores``, ``gc_scores``, held
against the jitted reference, which fuses their multiply-adds); read
latencies exact (integer-valued); the wear multiplier at a non-zero slope
rtol 1e-6 (the two frameworks' ``pow`` may differ in the last ulp).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ssd_parity import port_config

from repro.core import controller as j_ctl
from repro.core import faults as j_flt
from repro.core import hotness as j_hot
from repro.core import modes as j_modes
from repro.core import policy as j_policy
from repro.core import reclaim as j_rec
from repro.core import retry as j_retry
from repro.ssdsim import geometry as j_geo
from repro.ssdsim import state as j_st
from repro_torch import convert
from repro_torch.core import controller, faults, hotness, modes, policy, reclaim, retry
from repro_torch.ssdsim import geometry


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pe(rng, n):
    """P/E counts spread over all three stages, with each stage edge present."""
    pe = rng.integers(0, 1200, n).astype(np.int32)
    pe[:6] = [333, 334, 666, 667, 0, 1_000_000]
    return pe


# ------------------------------- modes -------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_stage_of(seed):
    pe = _pe(np.random.default_rng(seed), 4096)
    out = modes.stage_of(_t(pe))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_modes.stage_of(pe)))


def test_pe_limit_table():
    out = modes.table(modes.PE_LIMIT, "cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_modes.PE_LIMIT))


@pytest.mark.parametrize("args", [
    ("tbw_bytes", (16 * 2**30, 1000, 1.7)), ("tbw_bytes", (2**33, 3000, 0.0)),
    ("dwpd", (3.2e9, 16 * 2**30)), ("dwpd", (1.0, 0.0)),
    ("lifetime_years", (1e15, 2e9)), ("lifetime_years", (1e15, 0.0)),
    ("dwpd_for_lifetime", (1e15, 16 * 2**30, 5.0)),
])
def test_endurance_helpers(args):
    name, a = args
    assert getattr(modes, name)(*a) == getattr(j_modes, name)(*a)


# ------------------------------ hotness ------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_and_update_heat(seed):
    rng = np.random.default_rng(seed)
    heat = (rng.random(512) * 3).astype(np.float32)
    # duplicates accumulate, negative indices wrap, out-of-range drop
    idx = np.concatenate([rng.integers(0, 512, 300), [-1, -512, 512, 10_000, 7, 7, 7]])
    idx = idx.astype(np.int32)
    hc = j_hot.HeatConfig()
    for amount in (1.0, 0.25):
        np.testing.assert_array_equal(
            hotness.accumulate(_t(heat), _t(idx), amount).numpy(),
            np.asarray(jax.jit(lambda h, i: j_hot.accumulate(h, i, amount))(heat, idx)))
    out = hotness.update_heat(_t(heat), _t(idx), hotness.HeatConfig(*hc))
    ref = jax.jit(lambda h, i: j_hot.update_heat(h, i, hc))(heat, idx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ------------------------------- policy ------------------------------------

@pytest.mark.parametrize("r1", [1, 3])
def test_stage_thresholds(r1):
    pe = _pe(np.random.default_rng(r1), 2048)
    ref = j_policy.stage_thresholds(pe, r1=r1)
    out = policy.stage_thresholds(_t(pe), r1=r1)
    assert int(out.r1) == int(ref.r1)
    assert out.r2.dtype == torch.int32
    np.testing.assert_array_equal(out.r2.numpy(), np.asarray(ref.r2))


@pytest.mark.parametrize("seed", [0, 1])
def test_hotness_only_decision(seed):
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 3, 2048).astype(np.int32)
    cls = rng.integers(0, 3, 2048).astype(np.int32)
    out = policy.hotness_only_decision(_t(mode), _t(cls))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(j_policy.hotness_only_decision(mode, cls)))


# ------------------------------- retry -------------------------------------

def test_read_latency_us():
    rng = np.random.default_rng(0)
    mode = rng.integers(0, 3, 4096).astype(np.int32)
    n = rng.integers(0, 17, 4096).astype(np.int32)
    out = retry.read_latency_us(_t(mode), _t(n))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_retry.read_latency_us(mode, n)))


# ----------------------------- controller ----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_conversion_plan(seed):
    rng = np.random.default_rng(seed)
    n_pages, n_blocks = 4096, 64
    page_mode = rng.integers(0, 3, n_pages).astype(np.int32)
    page_target = np.minimum(page_mode, rng.integers(0, 3, n_pages)).astype(np.int32)
    page_block = rng.integers(0, n_blocks, n_pages).astype(np.int32)
    page_valid = rng.random(n_pages) < 0.7
    block_mode = rng.integers(0, 3, n_blocks).astype(np.int32)
    ref = j_ctl.block_conversion_plan(page_target, page_mode, page_block, page_valid,
                                      n_blocks, block_mode)
    out = controller.block_conversion_plan(_t(page_target), _t(page_mode), _t(page_block),
                                           _t(page_valid), n_blocks, _t(block_mode))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_page_decisions(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    mode = rng.integers(0, 3, n).astype(np.int32)
    heat = (rng.random(n) * 3).astype(np.float32)
    pe = _pe(rng, n)
    time_h = (24 + rng.random(n) * 200).astype(np.float32)
    reads = rng.integers(0, 20_000, n).astype(np.int32)
    ids = rng.integers(0, 2**20, n).astype(np.int32)
    hc = j_hot.HeatConfig()
    ref = jax.jit(lambda *a: j_ctl.raro_page_decision(*a, hc, r1=1))(
        mode, heat, pe, time_h, reads, ids)
    out = controller.raro_page_decision(_t(mode), _t(heat), _t(pe), _t(time_h), _t(reads),
                                        _t(ids), hotness.HeatConfig(*hc), r1=1)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    ref = j_ctl.hotness_page_decision(mode, heat, hc)
    out = controller.hotness_page_decision(_t(mode), _t(heat), hotness.HeatConfig(*hc))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ------------------------------- faults ------------------------------------

def _uniform01_numpy(ident, cycle, seed, stream):
    """The reference's draw replayed in numpy uint32 (wrapping) arithmetic."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        h = ident.astype(np.uint32) * np.uint32(0x9E3779B9)
        h = mix(h ^ (cycle.astype(np.uint32) * np.uint32(0x68E31DA4)))
        h = mix(h ^ (np.uint32(np.int64(seed) & 0xFFFFFFFF) * np.uint32(0xB5297A4D))
                ^ np.uint32(stream))
    return ((h & np.uint32(0xFFFFFF)).astype(np.float32) + np.float32(0.5)) / np.float32(2**24)


STREAMS = [faults.STREAM_PROG, faults.STREAM_ERASE, faults.STREAM_READ, faults.STREAM_REBUILD]


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_uniform01_bit_exact(seed):
    rng = np.random.default_rng(abs(seed))
    ident = np.concatenate([rng.integers(0, 2**31 - 1, 2048), [0, 1, 2**31 - 1]]).astype(np.int32)
    cycle = rng.integers(0, 5000, ident.shape[0]).astype(np.int32)
    for stream, j_stream in zip(STREAMS, [j_flt.STREAM_PROG, j_flt.STREAM_ERASE,
                                          j_flt.STREAM_READ, j_flt.STREAM_REBUILD]):
        assert stream == int(j_stream)
        out = faults.uniform01(_t(ident), _t(cycle), torch.tensor(seed, dtype=torch.int32),
                               stream).numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, _uniform01_numpy(ident, cycle, seed, stream))
        np.testing.assert_array_equal(
            out, np.asarray(j_flt.uniform01(ident, cycle, jnp.int32(seed), j_stream)))


def _fault_cfg(**kw):
    base = dict(prog_fail_rate=0.01, erase_fail_rate=0.05, read_fail_rate=0.02,
                max_read_retries=10, fault_seed=3, parity_rebuild=True)
    base.update(kw)
    ref = j_geo.tiny_config(**base)
    return ref, port_config(ref, geometry)


@pytest.mark.parametrize("slope", [0.0, 3.0])
def test_fault_draws(slope):
    j_cfg, t_cfg = _fault_cfg(fault_wear_slope=slope)
    jp, tp = j_flt.params_for(j_cfg), faults.params_for(t_cfg, device="cpu")
    for f in ("max_read_retries", "prog_fail_rate", "erase_fail_rate", "read_fail_rate",
              "wear_slope", "parity_rebuild", "seed", "read_recovery_us", "wear_power"):
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)))
    rng = np.random.default_rng(1)
    n = 8192
    ident = rng.integers(0, 2**20, n).astype(np.int32)
    mode = rng.integers(0, 3, n).astype(np.int32)
    pe = rng.integers(0, 3000, n).astype(np.int32)
    rated = np.asarray(j_modes.PE_LIMIT)[mode]
    wm = faults.wear_mult(tp, _t(pe), _t(rated)).numpy()
    wm_ref = np.asarray(jax.jit(lambda a, b: j_flt.wear_mult(jp, a, b))(pe, rated))
    if slope == 0.0:
        np.testing.assert_array_equal(wm, np.ones_like(wm))
        np.testing.assert_array_equal(wm_ref, np.ones_like(wm_ref))
    else:
        np.testing.assert_allclose(wm, wm_ref, rtol=1e-6)
    for name in ("prog_fails", "erase_fails", "read_fails"):
        out = getattr(faults, name)(tp, _t(ident), _t(pe), _t(rated)).numpy()
        ref = np.asarray(jax.jit(lambda a, b, c: getattr(j_flt, name)(jp, a, b, c))(
            ident, pe, rated))
        assert out.any()
        np.testing.assert_array_equal(out, ref)
    out = faults.rebuild_second_fault(tp, _t(ident), _t(pe), _t(rated), 3).numpy()
    ref = np.asarray(jax.jit(lambda a, b, c: j_flt.rebuild_second_fault(jp, a, b, c, 3))(
        ident, pe, rated))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_recovery_us_and_block_entity(parity, channels):
    j_cfg, t_cfg = _fault_cfg(parity_rebuild=parity, n_channels=channels)
    jp, tp = j_flt.params_for(j_cfg), faults.params_for(t_cfg, device="cpu")
    mode = np.array([0, 1, 2, 2, 1, 0], np.int32)
    np.testing.assert_array_equal(faults.recovery_us(tp, _t(mode), t_cfg).numpy(),
                                  np.asarray(j_flt.recovery_us(jp, mode, j_cfg)))
    blk = np.arange(t_cfg.n_blocks, dtype=np.int32)
    for planes in (1, 2):
        np.testing.assert_array_equal(
            faults.block_entity(_t(blk), t_cfg.n_dies, planes).numpy(),
            np.asarray(j_flt.block_entity(blk, j_cfg.n_dies, planes)))


def test_params_for_knobs_and_off():
    from repro.ssdsim import policies as j_pol
    from repro_torch.ssdsim import policies

    j_cfg = j_geo.tiny_config()
    t_cfg = port_config(j_cfg, geometry)
    assert faults.params_for(t_cfg, device="cpu") is None
    kw = dict(r1=1, r2_override=-1, initial_pe=500, prog_fail_rate=0.01, erase_fail_rate=0.02,
              max_read_retries=9, fault_seed=5, parity_rebuild=1)
    jp = j_flt.params_for(j_cfg, j_pol.RunKnobs(**kw))
    tp = faults.params_for(t_cfg, policies.RunKnobs(**kw), device="cpu")
    for f in j_flt.FaultParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)))


# ------------------------------- reclaim -----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_tie_order(seed):
    rng = np.random.default_rng(seed)
    # few distinct values (many ties) and masked lanes; k past the eligible count
    scores = rng.integers(0, 4, 96).astype(np.float32)
    eligible = rng.random(96) < 0.3
    for k in (1, 5, 40):
        ref = j_rec._topk(scores, eligible, k)
        out = reclaim._topk(_t(scores), _t(eligible), k)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _demotion_inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 3, n).astype(np.int32)
    heat = (rng.random(n) * rng.choice([0.001, 1.0, 50.0], n)).astype(np.float32)
    heat[:8] = heat[8:16]  # exact ties in heat
    age = rng.integers(0, 8, n).astype(np.int32)
    return mode, heat, age


@pytest.mark.parametrize("seed", [0, 1])
def test_demotion_scores_and_select(seed):
    mode, heat, age = _demotion_inputs(seed)
    ref = jax.jit(j_rec.demotion_scores)(mode, heat, age)
    out = reclaim.demotion_scores(_t(mode), _t(heat), _t(age))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for free_frac in (0.05, 0.5):
        rc = j_rec.ReclaimConfig(max_per_pass=6)
        ref = jax.jit(lambda m, h, a: j_rec._demotion_select(m, h, a, free_frac, rc))(
            mode, heat, age)
        out = reclaim._demotion_select(_t(mode), _t(heat), _t(age), free_frac,
                                       reclaim.ReclaimConfig(*rc))
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _block_state(seed, cfg):
    """A state whose per-block leaves are random (the mapping leaves stay
    those of the initial state): all the GC scorers read."""
    rng = np.random.default_rng(seed)
    s = j_st.init_state(cfg)
    B = cfg.n_blocks
    mode = rng.integers(0, 3, B).astype(np.int32)
    ppb = np.asarray(j_geo.pages_per_block_host(cfg))
    valid = np.minimum(rng.integers(0, cfg.slots_per_block + 1, B), ppb[mode]).astype(np.int32)
    valid[:10] = valid[10:20]
    mode[:10] = mode[10:20]
    state = rng.choice([0, 1, 2, 2, 2], B).astype(np.int32)
    pe = rng.integers(0, 3000, B).astype(np.int32)
    pe[:10] = pe[10:20]
    s = s._replace(block_mode=jnp.asarray(mode), block_valid=jnp.asarray(valid),
                   block_state=jnp.asarray(state), block_pe=jnp.asarray(pe),
                   block_cold_age=jnp.asarray(rng.integers(0, 9, B).astype(np.int32)))
    return s, convert.ssd_state_from_numpy([np.asarray(x) for x in s], device="cpu")


@pytest.mark.parametrize("objective", ["min_valid", "lifespan"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gc_scores_and_score_victims(objective, seed):
    j_cfg = j_geo.tiny_config(gc_objective=objective, gc_alpha=0.9, gc_beta=0.7, gc_gamma=0.3)
    t_cfg = port_config(j_cfg, geometry)
    js, ts = _block_state(seed, j_cfg)
    ref = jax.jit(lambda s: j_rec.gc_scores(s, j_cfg, objective))(js)
    np.testing.assert_array_equal(reclaim.gc_scores(ts, t_cfg, objective).numpy(),
                                  np.asarray(ref))
    for code in (0, 1):
        ref = jax.jit(lambda s, c: j_rec.gc_scores(s, j_cfg, objective, c))(js, code)
        out = reclaim.gc_scores(ts, t_cfg, objective, torch.tensor(code))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for k in (1, 4, 9):
        ref = jax.jit(lambda s: j_rec.score_victims(s, j_cfg, objective, k=k))(js)
        out = reclaim.score_victims(ts, t_cfg, objective, k=k)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    heat = (np.random.default_rng(seed).random(j_cfg.n_blocks) * 4).astype(np.float32)
    rc = j_rec.ReclaimConfig(max_per_pass=5)
    ref = jax.jit(lambda s, h: j_rec.score_victims(
        s, j_cfg, j_rec.DEMOTION, block_heat=h, free_frac=0.1, reclaim_cfg=rc))(js, heat)
    out = reclaim.score_victims(ts, t_cfg, reclaim.DEMOTION, block_heat=_t(heat),
                                free_frac=0.1, reclaim_cfg=reclaim.ReclaimConfig(*rc))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_score_victims_rejects_bad_calls():
    t_cfg = port_config(j_geo.tiny_config(), geometry)
    _, ts = _block_state(0, j_geo.tiny_config())
    with pytest.raises(ValueError, match="unknown victim objective"):
        reclaim.score_victims(ts, t_cfg, "oldest", k=2)
    with pytest.raises(ValueError, match="explicit k"):
        reclaim.score_victims(ts, t_cfg, reclaim.GC_MIN_VALID)
    with pytest.raises(ValueError, match="demotion objective needs"):
        reclaim.score_victims(ts, t_cfg, reclaim.DEMOTION)
    assert reclaim.GC_OBJECTIVES == j_rec.GC_OBJECTIVES == geometry.GC_OBJECTIVES
    assert reclaim.GC_OBJECTIVE_CODES == j_rec.GC_OBJECTIVE_CODES


@pytest.mark.parametrize("name", ["select_demotions", "topk_victims",
                                  "select_demotion_victims"])
def test_deprecated_shims_warn_once_and_agree(name):
    mode, heat, age = _demotion_inputs(3)
    rc = j_rec.ReclaimConfig(max_per_pass=4)
    if name == "topk_victims":
        args = (heat, age > 3, 6)
        targs = (_t(heat), _t(age > 3), 6)
    else:
        args = (mode, heat, age, 0.05, rc)
        targs = (_t(mode), _t(heat), _t(age), 0.05, reclaim.ReclaimConfig(*rc))
    reclaim._DEPRECATED_WARNED.discard(name)
    with pytest.warns(DeprecationWarning, match=f"reclaim.{name} is deprecated"):
        out = getattr(reclaim, name)(*targs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        getattr(reclaim, name)(*targs)  # warns once per process
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = getattr(j_rec, name)(*args)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_reference_jit_fuses_multiply_adds():
    """Pins a property of the reference (ROADMAP queue 3): under ``jax.jit``
    on the CPU, XLA fuses a multiply feeding an add into one FMA, so the
    jitted ``demotion_scores`` (as the engine runs it) differs in the last
    bit from the same function run eagerly; the port follows the jitted
    one."""
    rng = np.random.default_rng(0)
    n = 50_000
    mode = np.zeros(n, np.int32)
    heat = (rng.random(n) * 5).astype(np.float32)
    age = rng.integers(0, 9, n).astype(np.int32)
    jitted = np.asarray(jax.jit(j_rec.demotion_scores)(mode, heat, age))
    eager = np.asarray(j_rec.demotion_scores(mode, heat, age))
    assert (jitted != eager).any()
    assert np.abs(jitted - eager).max() <= np.spacing(np.float32(9.0))
    np.testing.assert_array_equal(
        reclaim.demotion_scores(_t(mode), _t(heat), _t(age)).numpy(), jitted)
