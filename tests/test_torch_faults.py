"""Twin of tests/test_faults.py: the port's fault injection and recovery
(``repro_torch.core.faults``, the engine's fault paths,
``state.check_invariants``), held by the reference's assertions on the CPU
with the same seeds, sizes and hypothesis settings: parameter plumbing,
the bit-identity of the no-fault path, the three fault classes, graceful
degradation and random fault schedules. (``TestSweepResume`` and
``TestDeviceClamp`` have their twins in test_torch_sweep.py.) Where the
reference batches runs through ``sweep._sweep_jit``, the twin runs each
with ``sweep.run_one`` (``torch_twins.knob_runs``). The uncorrectable-read
run is held against the JAX package's engine.
"""

import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import CPU, check_against_reference, knob_runs, pressure_cfg, run
from torch_twins import mixed as _mixed

from repro_torch.core import faults
from repro_torch.experiments import sweep
from repro_torch.ssdsim import geometry, policies, state as st, workload

TINY = geometry.tiny_config()


# --------------------------- parameter plumbing ----------------------------


class TestParams:
    def test_defaults_are_statically_off(self):
        assert not TINY.faults_enabled
        assert faults.params_for(TINY) is None
        # knobs without fault fields don't arm the model either
        k = policies.RunKnobs(r1=1, r2_override=-1, initial_pe=500)
        assert faults.params_for(TINY, k) is None

    def test_config_path_arms(self):
        cfg = geometry.tiny_config(prog_fail_rate=0.1)
        assert cfg.faults_enabled
        p = faults.params_for(cfg, device=CPU)
        assert float(p.prog_fail_rate) == pytest.approx(0.1)
        assert int(p.max_read_retries) == -1

    def test_knobs_path_wins_over_config(self):
        cfg = geometry.tiny_config(prog_fail_rate=0.1)
        k = policies.RunKnobs(
            r1=1, r2_override=-1, initial_pe=500,
            prog_fail_rate=np.float32(0.25), erase_fail_rate=np.float32(0.0),
            max_read_retries=np.int32(4), fault_seed=np.int32(7),
        )
        p = faults.params_for(cfg, k, device=CPU)
        assert float(p.prog_fail_rate) == pytest.approx(0.25)
        assert int(p.max_read_retries) == 4

    def test_draws_uniform_deterministic_and_stream_separated(self):
        ids = torch.arange(4_096, dtype=torch.int32)
        pe = torch.full_like(ids, 500)
        u1 = faults.uniform01(ids, pe, 1, faults.STREAM_PROG).numpy()
        u2 = faults.uniform01(ids, pe, 1, faults.STREAM_PROG).numpy()
        ue = faults.uniform01(ids, pe, 1, faults.STREAM_ERASE).numpy()
        assert ((u1 > 0.0) & (u1 < 1.0)).all()
        np.testing.assert_array_equal(u1, u2)  # stateless + reproducible
        assert (u1 != ue).mean() > 0.99  # PROG and ERASE never share a draw
        # roughly uniform: each decile within a few points of 10%
        hist, _ = np.histogram(u1, bins=10, range=(0.0, 1.0))
        assert (np.abs(hist / len(u1) - 0.1) < 0.03).all()


# ------------------------- no-fault bit identity ---------------------------


class TestZeroFaultBitIdentity:
    def test_traced_zero_rates_match_knob_free_program(self):
        """The fault ops run from the knobs (rates 0.0, budget -1) must
        reproduce the knob-free runs' summaries bit for bit — the property
        that lets one grid mix fault-free and faulty runs."""
        base = dict(
            scenario="write_burst_then_read", n_requests=2_048,
            policies=(geometry.BASELINE, geometry.RARO),
            initial_pe=(833,), seeds=(0,), base=TINY,
        )
        plain = sweep.run_sweep(sweep.SweepSpec(**base), device=CPU)
        # fault_seed != default flips faults_on() -> the fault ops run and
        # the knobs ride each run, but no draw can fire
        armed = sweep.run_sweep(sweep.SweepSpec(**base, fault_seed=(1,)), device=CPU)
        assert len(plain) == len(armed)
        for a, b in zip(plain, armed):
            assert a["run"]["policy"] == b["run"]["policy"]
            for key, val in a.items():
                if key == "run":
                    continue
                np.testing.assert_array_equal(
                    np.asarray(val), np.asarray(b[key]),
                    err_msg=f"summary key {key!r} diverged with zero-rate "
                            f"fault knobs on",
                )

    def test_fault_counters_zero_when_off(self):
        s, _ = run(TINY, _mixed(TINY))
        for leaf in (s.n_uncorrectable, s.n_prog_fails, s.n_erase_fails,
                     s.n_dropped_writes, s.bad_count):
            assert float(leaf) == 0.0


# ------------------------- the three fault classes -------------------------


class TestUncorrectableReads:
    @pytest.fixture(scope="class")
    def runs(self):
        mk = lambda **kw: geometry.tiny_config(  # noqa: E731
            policy=geometry.BASELINE, initial_pe=900, **kw)
        cfg = mk(max_read_retries=2, fault_seed=1)
        tr = workload.zipf_read_trace(cfg, 8_192, 1.2, seed=1)
        s, _ = run(cfg, tr)
        s0, _ = run(mk(), tr)  # same trace, unlimited retries
        return cfg, s, s0, tr

    def test_uncorrectables_fire_and_invariants_hold(self, runs):
        cfg, s, _, _ = runs
        assert float(s.n_uncorrectable) > 0
        st.check_invariants(s, cfg)

    def test_recovery_penalty_shows_in_latency(self, runs):
        cfg, s, s0, _ = runs
        assert float(s.n_reads) == float(s0.n_reads)  # no read is dropped
        mean = float(s.svc_sum_ms) / float(s.n_reads)
        mean0 = float(s0.svc_sum_ms) / float(s0.n_reads)
        # worn QLC at pe=900 retries far past a budget of 2: most reads pay
        # the 5 ms recovery penalty (partly offset by the collapsed retries)
        assert mean > 2.0 * mean0

    def test_budget_collapses_retry_count(self, runs):
        cfg, s, s0, _ = runs
        # an uncorrectable read burns exactly the budget, never more
        assert float(s.n_retries) < float(s0.n_retries)

    def test_run_equals_reference(self, runs):
        cfg, s, _, tr = runs
        check_against_reference(cfg, tr, s)


class TestProgramFailures:
    @pytest.fixture(scope="class")
    def runs(self):
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=500,
                                   prog_fail_rate=0.05, fault_seed=1)
        tr = _mixed(cfg)
        s, _ = run(cfg, tr)
        s0, _ = run(geometry.tiny_config(
            policy=geometry.BASELINE, initial_pe=500), tr)
        return cfg, s, s0

    def test_prog_fails_fire_and_invariants_hold(self, runs):
        cfg, s, _ = runs
        assert float(s.n_prog_fails) > 0
        st.check_invariants(s, cfg)

    def test_failed_programs_are_replaced_not_lost(self, runs):
        cfg, s, s0 = runs
        # every write the fault-free run completed still completes: the
        # failed page re-places through ftl._place_pages onto a fresh block
        assert float(s.n_writes) == float(s0.n_writes)
        assert float(s.n_dropped_writes) == 0.0
        assert (np.asarray(s.l2p) >= 0).all()


class TestEraseFailures:
    @pytest.fixture(scope="class")
    def run(self):
        # the engine-bench gc_pressure geometry: tiny free pool + write-heavy
        # Zipf overwrites, so GC erases fire on nearly every chunk
        cfg = pressure_cfg()
        tr = _mixed(cfg, n=16_384, read_frac=0.1, write_theta=2.0)
        s, _ = run(cfg, tr)
        return cfg, s

    def test_blocks_retire_into_bad_map(self, run):
        cfg, s = run
        assert float(s.bad_count) > 0
        bs = np.asarray(s.block_state)
        bad = np.asarray(s.block_bad)
        np.testing.assert_array_equal(bad, bs == st.BAD)
        assert float(s.n_erase_fails) == float(s.bad_count)
        # retired blocks hold nothing and are excluded from usable capacity
        assert (np.asarray(s.block_valid)[bad] == 0).all()
        st.check_invariants(s, cfg)

    def test_erase_attempts_include_failures(self, run):
        cfg, s = run
        assert float(s.n_erases) > float(s.n_erase_fails)


class TestGracefulDegradation:
    def test_alloc_exhaustion_stalls_instead_of_corrupting(self):
        # fault_storm shape on a worn tiny device: concentrated overwrites
        # outrun the free pool, so some writes find no open slot. They must
        # stall (counted in n_dropped_writes) and leave the state coherent.
        cfg = geometry.tiny_config(
            policy=geometry.BASELINE, initial_pe=900,
            max_read_retries=6, erase_fail_rate=0.05, fault_seed=1,
        )
        tr = _mixed(cfg, read_frac=0.3, write_theta=2.0, seed=0)
        s, _ = run(cfg, tr)
        assert float(s.n_dropped_writes) > 0
        st.check_invariants(s, cfg)


# --------------------- property test: random schedules ---------------------


class TestFaultScheduleProperty:
    R = 3  # runs of each example, as the reference's batch width

    @settings(max_examples=8, deadline=None)
    @given(
        pfail=st_h.lists(st_h.floats(0.0, 0.3), min_size=R, max_size=R),
        efail=st_h.lists(st_h.floats(0.0, 0.3), min_size=R, max_size=R),
        mrr=st_h.lists(st_h.integers(-1, 8), min_size=R, max_size=R),
        seed=st_h.integers(0, 2**16),
    )
    def test_random_fault_schedules_never_break_invariants(
            self, pfail, efail, mrr, seed):
        """Any mix of fault rates / retry budgets / seeds across a batched
        run axis keeps every per-run state consistent: mapping bijection,
        exact free counts, bad-block accounting."""

        cfg = geometry.tiny_config(policy=geometry.RARO)
        tr = _mixed(cfg, n=2_048, read_frac=0.5, write_theta=2.0)
        knobs = dict(
            r1=np.full(self.R, cfg.r1, np.int32),
            r2_override=np.full(self.R, -1, np.int32),
            initial_pe=np.full(self.R, 833, np.int32),
            prog_fail_rate=np.asarray(pfail, np.float32),
            erase_fail_rate=np.asarray(efail, np.float32),
            max_read_retries=np.asarray(mrr, np.int32),
            fault_seed=np.asarray([seed + i for i in range(self.R)], np.int32),
        )
        # the reference's sweep._sweep_jit + sweep._take_run, run by run
        for s in knob_runs(cfg, tr, knobs):
            st.check_invariants(s, cfg)
            assert float(s.bad_count) == float(s.n_erase_fails)
