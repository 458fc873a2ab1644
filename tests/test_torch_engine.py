"""The port's engine (repro_torch.ssdsim.engine) against the JAX package's
on the CPU: the Lindley recursions on random lanes, and ``engine.run`` +
``summarize`` end to end on ``tiny_config`` for the closed-loop cases:
the three policies on zipf reads (RARO converting until GC and reclaim
fire, at ``obs_level="full"``) and a mixed read/write trace under GC.
``test_torch_engine_open.py`` holds the open-loop, faults-armed and
``RunKnobs`` cases. Each trace comes from the ported ``workload``; each JAX
run is shared by the tests of its case (``torch_ssd_parity.run_engine_case``).

Tolerance (the comparison rule): integer ``SSDState`` leaves, integer
``ChunkMetrics`` fields and count-valued summary entries exact; float
leaves and summary values rtol 1e-5; latency histograms equal totals with
no count moved by more than one bin; the Lindley recursions' departure
times rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
import torch_ssd_parity as parity

from repro.ssdsim import engine as j_eng
from repro_torch.ssdsim import engine, geometry, state as st, workload

CASES = ["baseline", "hotness", "raro_gc_reclaim_obs_full", "mixed_gc"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return parity.run_engine_case(request.param)


def test_state_matches_reference(case):
    parity.check_engine_state(case)


def test_summary_matches_reference(case):
    parity.check_engine_summary(case)


def test_chunk_metrics_match_reference(case):
    parity.check_engine_metrics(case)


def test_case_exercises_its_path(case):
    parity.check_engine_reaches(case)


@pytest.mark.parametrize("n_res", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_lindley_recursions(n_res, seed):
    rng = np.random.default_rng(seed)
    C = 256
    arrival = np.sort(rng.random(C) * 20).astype(np.float32)
    arrival[::7] = arrival[::7][::-1].copy()  # out-of-order lanes serve in lane order
    occ = (rng.integers(20, 3000, C) * np.float32(0.001)).astype(np.float32)
    xfer = np.full(C, np.float32(0.02048), np.float32)
    lun = rng.integers(0, n_res, C).astype(np.int32)
    chan = (lun % 2).astype(np.int32)
    rd = rng.random(C) < 0.6
    active = rng.random(C) < 0.9
    avail0 = (rng.random(n_res) * 5).astype(np.float32)
    chan0 = (rng.random(2) * 5).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        arrival=arrival, occ=occ, xfer=xfer, lun=lun, chan=chan, rd=rd, active=active,
        avail0=avail0, chan0=chan0).items()}
    ref = jax.jit(lambda *a: j_eng._queue_departures(*a, n_res))(
        avail0, arrival, occ, lun, active)
    out = engine._queue_departures(t["avail0"], t["arrival"], t["occ"], t["lun"],
                                   t["active"], n_res)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=0)
    ref = jax.jit(lambda *a: j_eng._tandem_departures(*a, n_res, 2))(
        avail0, chan0, arrival, occ, xfer, lun, chan, rd, active)
    out = engine._tandem_departures(t["avail0"], t["chan0"], t["arrival"], t["occ"], t["xfer"],
                                    t["lun"], t["chan"], t["rd"], t["active"], n_res, 2)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=0)


def test_entry_points_default_to_the_card():
    """With no device named, the entry points run on CUDA, and raise where
    there is none (no silent fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    cfg = geometry.tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run(cfg, workload.zipf_read_trace(cfg, 256, 1.2))


def test_run_is_deterministic_and_leaves_input_state_alone():
    cfg = geometry.tiny_config(policy=geometry.RARO, n_logical=2944, gc_free_threshold=18,
                               gc_victims_per_pass=4, initial_pe=500, device_age_h=24.0)
    trace = workload.mixed_trace(cfg, cfg.chunk * 6, 1.2, read_frac=0.3, write_theta=2.0)
    s0 = st.init_state(cfg, device="cpu")
    before = [x.clone() for x in s0]
    s = s0
    lp, op = torch.from_numpy(trace["lpn"]), torch.from_numpy(trace["op"])
    for c in range(lp.shape[0]):
        s, _ = engine.step_chunk(s, (lp[c], op[c]), cfg, True)
    for a, b in zip(before, s0):
        assert torch.equal(a, b)
    again, _ = engine.run(cfg, trace, device="cpu")
    for a, b in zip(s, again):
        assert torch.equal(a, b)
