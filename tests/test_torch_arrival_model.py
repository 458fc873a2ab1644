"""Twin of tests/test_arrival_model.py: the port's open-loop arrival model
(``workload``'s arrival builders, ``engine._queue_departures``, the
open-loop engine, ``experiments.{registry,sweep}``), held by the
reference's assertions on the CPU with the same seeds, sizes and
hypothesis settings: arrival builders, the per-LUN Lindley queueing
recursion against a sequential reference, saturation equivalence with the
closed-loop engine, the M/G/1 sanity and low/high-load regression, the
arrival_scale sweep knob, open-loop replay and the policy's dedup. The
single-LUN saturated run is held against the JAX package's engine."""

import numpy as np
import pytest
from hyp_fallback import given, settings
from hyp_fallback import st as st_h

import torch
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import check_against_reference, f32, i32, run

from repro_torch.experiments import registry, sweep
from repro_torch.ssdsim import engine, geometry, workload

TINY = geometry.tiny_config()

# latency telemetry intentionally differs between the models (open-loop
# records queueing-inclusive latency); everything else must agree when the
# open-loop run is saturated from t=0
_TIMING_FIELDS = {"lat_hist", "w_lat_hist", "svc_sum_ms", "q_sum_ms",
                  "chanq_sum_ms", "die_avail_ms", "chan_avail_ms",
                  "clock_ms", "die_busy_ms", "chan_busy_ms",
                  "page_write_ms", "heat", "n_retries"}


def _zero_arrivals(trace):
    out = dict(trace)
    out["arrival_ms"] = np.zeros(trace["lpn"].shape, np.float32)
    return out


class TestArrivalBuilders:
    def test_poisson_monotone_zero_based_mean_gap(self):
        t = workload.poisson_arrival_ms(50_000, rate_iops=10_000.0, seed=3)
        assert t[0] == 0.0
        assert (np.diff(t) >= 0).all()
        gaps = np.diff(t)
        assert abs(gaps.mean() - 0.1) < 0.005  # 10k IOPS -> 0.1 ms mean gap

    def test_constant_rate_exact(self):
        t = workload.constant_arrival_ms(5, rate_iops=1000.0)
        np.testing.assert_allclose(t, [0.0, 1.0, 2.0, 3.0, 4.0])

    def test_unknown_dist_raises(self):
        with pytest.raises(ValueError):
            workload.build_arrivals(10, 100.0, dist="bursty")

    def test_pack_pads_arrivals_with_last(self):
        n = TINY.chunk - 5
        arr = np.arange(n, dtype=np.float64)
        tr = workload._pack(TINY, np.zeros(n, np.int32),
                            np.zeros(n, np.int32), arr)
        flat = tr["arrival_ms"].reshape(-1)
        assert tr["arrival_ms"].dtype == np.float32
        assert (flat[n:] == flat[n - 1]).all()

    def test_attach_arrivals_shape_and_determinism(self):
        tr = workload.zipf_read_trace(TINY, 3_000, 1.2, seed=0)
        a = workload.attach_arrivals(TINY, tr, 5_000.0, seed=7)
        b = workload.attach_arrivals(TINY, tr, 5_000.0, seed=7)
        assert a["arrival_ms"].shape == a["lpn"].shape
        np.testing.assert_array_equal(a["arrival_ms"], b["arrival_ms"])
        assert "arrival_ms" not in tr  # original untouched

    def test_generators_accept_arrival_rate(self):
        for tr in (
            workload.zipf_read_trace(TINY, 2_000, 1.2, seed=0, arrival_rate=1e4),
            workload.mixed_trace(TINY, 2_000, 1.2, seed=0, arrival_rate=1e4,
                                 arrival_dist="constant"),
        ):
            assert "arrival_ms" in tr
            flat = tr["arrival_ms"].reshape(-1)
            assert (np.diff(flat) >= 0).all()


class TestQueueDepartures:
    """Unit tests of the vectorized Lindley recursion against a reference
    per-request simulation."""

    def _reference(self, avail0, arr, svc, lun, active, n_luns):
        avail = np.array(avail0, np.float64)
        dep = np.zeros(len(arr))
        for i in range(len(arr)):
            if not active[i]:
                dep[i] = avail[lun[i]]
                continue
            start = max(arr[i], avail[lun[i]])
            avail[lun[i]] = start + svc[i]
            dep[i] = avail[lun[i]]
        return dep, avail

    @settings(max_examples=20, deadline=None)
    @given(seed=st_h.integers(0, 2**16))
    def test_matches_sequential_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, n_luns = 64, 4
        arr = np.sort(rng.random(n) * 10.0)
        svc = rng.random(n) * 0.5
        lun = rng.integers(0, n_luns, n)
        active = rng.random(n) < 0.8
        avail0 = rng.random(n_luns) * 2.0
        dep, avail1 = engine._queue_departures(
            f32(avail0), f32(arr), f32(np.where(active, svc, 0.0)),
            i32(lun), torch.as_tensor(active), n_luns,
        )
        ref_dep, ref_avail = self._reference(avail0, arr, svc, lun, active, n_luns)
        np.testing.assert_allclose(
            np.asarray(dep)[active], ref_dep[active], rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(np.asarray(avail1), ref_avail,
                                   rtol=1e-4, atol=1e-4)

    def test_idle_lun_keeps_avail(self):
        dep, avail1 = engine._queue_departures(
            f32([5.0, 7.0]), f32([0.0, 1.0]), f32([1.0, 1.0]), i32([0, 0]),
            torch.tensor([True, True]), 2,
        )
        # LUN 0 serves back-to-back from its availability clock; LUN 1 idle
        np.testing.assert_allclose(np.asarray(dep), [6.0, 7.0])
        np.testing.assert_allclose(np.asarray(avail1), [7.0, 7.0])


class TestSaturationEquivalence:
    """arrival_rate -> infinity (every arrival at t=0) saturates the device,
    so the open-loop engine must reproduce the closed-loop run exactly:
    identical FTL state and, per LUN, final availability == cumulative busy
    time (service is back-to-back with zero idling)."""

    @settings(max_examples=6, deadline=None)
    @given(
        seed=st_h.integers(0, 2**16),
        pol=st_h.sampled_from([geometry.BASELINE, geometry.RARO]),
    )
    def test_property_saturation_matches_closed_loop(self, seed, pol):
        cfg = geometry.tiny_config(policy=pol, initial_pe=500)
        tr = workload.mixed_trace(cfg, 2_000, 1.2, read_frac=0.8, seed=seed)
        s_c, _ = run(cfg, tr)
        s_o, _ = run(cfg, _zero_arrivals(tr))
        for name, a, b in zip(s_c._fields, s_c, s_o):
            if name in _TIMING_FIELDS:
                continue
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                assert (a == b).all(), name
        # service totals: no idling, so availability == busy time per LUN
        np.testing.assert_allclose(np.asarray(s_o.die_avail_ms),
                                   np.asarray(s_o.die_busy_ms),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(s_o.die_busy_ms),
                                   np.asarray(s_c.die_busy_ms),
                                   rtol=1e-4, atol=1e-3)
        assert float(s_o.lat_hist.sum()) == float(s_c.lat_hist.sum())

    @pytest.fixture(scope="class")
    def single_lun(self):
        cfg = geometry.tiny_config(n_channels=1, luns_per_channel=1,
                                   blocks_per_plane=64, policy=geometry.RARO,
                                   initial_pe=500)
        tr = workload.zipf_read_trace(cfg, 3_000, 1.2, seed=1)
        s_c, _ = run(cfg, tr)
        s_o, _ = run(cfg, _zero_arrivals(tr))
        return cfg, tr, s_c, s_o

    def test_single_lun_service_totals_exact(self, single_lun):
        cfg, tr, s_c, s_o = single_lun
        assert float(s_c.n_reads) == float(s_o.n_reads)
        assert float(s_c.n_retries) == float(s_o.n_retries)
        np.testing.assert_allclose(np.asarray(s_o.die_avail_ms),
                                   np.asarray(s_c.die_busy_ms), rtol=1e-5)

    def test_single_lun_saturated_run_equals_reference(self, single_lun):
        cfg, tr, _, s_o = single_lun
        check_against_reference(cfg, _zero_arrivals(tr), s_o)


class TestLoadRegression:
    def _hammer(self, cfg, rate):
        tr = registry.build("read_disturb_hammer", cfg, 6_000, seed=0)
        return workload.attach_arrivals(cfg, tr, rate, seed=1)

    def test_low_load_has_negligible_queueing(self):
        # ~5 IOPS against ~2.4 ms hammered-QLC reads: utilization ~1%, so
        # queueing is negligible even at the p99
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=833)
        s_o, _ = run(cfg, self._hammer(cfg, rate=5.0))
        m = engine.summarize(s_o, cfg)
        # queueing delay is a vanishing fraction of the recorded latency
        assert m["read_queue_delay_us"] < 0.05 * m["mean_read_latency_us"]
        # ... so the read histogram is within a bin of the closed-loop one
        tr = registry.build("read_disturb_hammer", cfg, 6_000, seed=0)
        s_c, _ = run(cfg, tr)
        m_c = engine.summarize(s_c, cfg)
        assert m["read_lat_p99_us"] == pytest.approx(m_c["read_lat_p99_us"],
                                                     rel=0.10)

    def test_high_load_p99_exceeds_closed_loop(self):
        """Acceptance criterion: at high offered load on a retry-heavy trace
        the open-loop p99 strictly exceeds the closed-loop p99 — queueing is
        visible in the histogram."""
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=833)
        tr = registry.build("read_disturb_hammer", cfg, 6_000, seed=0)
        s_c, _ = run(cfg, tr)
        m_c = engine.summarize(s_c, cfg)
        s_o, ys = run(cfg, self._hammer(cfg, rate=1e6))
        m_o = engine.summarize(s_o, cfg)
        assert m_o["read_lat_p99_us"] > m_c["read_lat_p99_us"]
        assert m_o["read_queue_delay_us"] > 0
        assert float(np.asarray(ys.q_ms).sum()) == pytest.approx(
            float(s_o.q_sum_ms), rel=1e-5)

    def test_queue_delay_monotone_in_offered_load(self):
        spec = sweep.SweepSpec(
            scenario="hammer_openloop", n_requests=4_000,
            policies=(geometry.BASELINE,), initial_pe=(833,), seeds=(0,),
            arrival_scale=(0.25, 4.0),
            scenario_kw=(("rate_iops", 2_000.0),), base=TINY,
        )
        res = sweep.run_sweep(spec, device="cpu")
        by = {r["run"]["arrival_scale"]: r for r in res}
        assert by[4.0]["read_queue_delay_us"] > by[0.25]["read_queue_delay_us"]
        assert by[4.0]["run"]["tag"].endswith("load4")
        assert by[0.25]["run"]["tag"].endswith("load0.25")

    def test_arrival_scale_warns_on_closed_loop_scenario(self):
        spec = sweep.SweepSpec(
            scenario="read_disturb_hammer", n_requests=1_000,
            policies=(geometry.BASELINE,), initial_pe=(166,), seeds=(0,),
            arrival_scale=(1.0, 2.0), base=TINY,
        )
        with pytest.warns(UserWarning, match="no arrival timestamps"):
            sweep.run_sweep(spec, device="cpu")


class TestMG1Sanity:
    """M/G/1 sanity check (ROADMAP open refinement): on a single-LUN device
    with Poisson read arrivals the measured mean queueing delay must match
    the Pollaczek-Khinchine formula  Wq = lambda * E[S^2] / (2 (1 - rho)).

    BASELINE policy + read-only trace keeps the mapping static (no
    migrations/GC/writes), so per-request service times are an iid draw from
    the initial state's per-page retry latencies: S = (1 + retries) * t_QLC.
    ``initial_pe=0`` keeps the retry table flat over the run (asserted via
    retries_per_read == the static expectation), i.e. service is stationary.
    """

    def _setup(self, n=30_000, theta=0.9, seed=5):
        from repro_torch.core import modes as m_, retry

        cfg = geometry.tiny_config(
            n_channels=1, luns_per_channel=1, blocks_per_plane=64,
            policy=geometry.BASELINE, initial_pe=0,
        )
        lpns = workload.zipf_read_trace(cfg, n, theta, seed=seed)["lpn"].reshape(-1)[:n]
        r = retry.page_retries(
            i32(m_.QLC), i32(cfg.initial_pe), f32(cfg.device_age_h), i32(0),
            torch.arange(cfg.n_slots, dtype=torch.int32),
        ).numpy()
        svc_ms = (1.0 + r[lpns]) * float(m_.READ_LATENCY_US[m_.QLC]) / 1000.0
        return cfg, r, svc_ms

    @pytest.mark.parametrize("rho_target", [0.4, 0.6, 0.75])
    def test_mean_queue_delay_matches_pollaczek_khinchine(self, rho_target):
        n, theta, seed = 30_000, 0.9, 5
        cfg, r, svc_ms = self._setup(n, theta, seed)
        es, es2 = svc_ms.mean(), (svc_ms**2).mean()
        lam = rho_target / es  # arrivals per ms
        tr = workload.zipf_read_trace(
            cfg, n, theta, seed=seed, arrival_rate=lam * 1000.0
        )
        s, _ = run(cfg, tr)
        m = engine.summarize(s, cfg)
        # stationarity: measured retries equal the static expectation, so
        # the host-side service moments describe the run
        assert m["retries_per_read"] == pytest.approx(
            float(np.mean(r[tr["lpn"].reshape(-1)[:n]])), rel=1e-3
        )
        rho = lam * es
        wq_us = lam * es2 / (2.0 * (1.0 - rho)) * 1000.0
        assert m["read_queue_delay_us"] == pytest.approx(wq_us, rel=0.15)


class TestOpenLoopReplay:
    def test_msr_sample_replays_open_loop(self):
        tr = registry.build("msr_sample", TINY, 2_000, seed=0)
        assert "arrival_ms" in tr
        flat = tr["arrival_ms"].reshape(-1)
        assert (np.diff(flat) >= 0).all()  # cycling keeps time monotone
        s, _ = run(TINY, tr)
        assert float(s.n_reads) + float(s.n_writes) == 2_000
        assert float(s.die_avail_ms.max()) > 0

    def test_msr_sample_closed_loop_opt_out(self):
        tr = registry.build("msr_sample", TINY, 1_000, seed=0, arrivals=False)
        assert "arrival_ms" not in tr
        s, _ = run(TINY, tr)
        assert float(s.die_avail_ms.max()) == 0.0


class TestPolicyDedup:
    """The engine's sort+adjacent-mask dedup must migrate each
    chunk-repeated LPN at most once and keep candidates in ascending LPN
    order (a sorted unique's tie-break)."""

    def test_hammered_single_page_keeps_invariants(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=833)
        tr = registry.build("read_disturb_hammer", cfg, 4_000, seed=0,
                            hammer_pages=1, hammer_prob=1.0)
        s, _ = run(cfg, tr)
        # double-migration of the duplicate would corrupt block_valid
        p2l = np.asarray(s.p2l)
        vslots = np.nonzero(p2l >= 0)[0]
        counts = np.bincount(vslots // cfg.slots_per_block,
                             minlength=cfg.n_blocks)
        assert (np.asarray(s.block_valid) == counts).all()
        assert (np.asarray(s.l2p) >= 0).all()

    def test_dedup_matches_jnp_unique_semantics(self):
        """The engine's inline sort+mask (torch ops) must select the same
        unique set (and -1 the rest) as a unique over the masked read
        LPNs."""
        rng = np.random.default_rng(4)
        for _ in range(20):
            lpns = rng.integers(0, 64, size=128).astype(np.int32)
            rd = rng.random(128) < 0.7
            srt = torch.sort(torch.where(torch.as_tensor(rd), i32(lpns), 64)).values
            dup = torch.cat([torch.zeros((1,), dtype=torch.bool), srt[1:] == srt[:-1]])
            uniq = torch.where((srt >= 64) | dup, -1, srt).numpy()
            expect = np.unique(lpns[rd])
            got = np.sort(uniq[uniq >= 0])
            np.testing.assert_array_equal(got, expect)
            # survivors stay ascending in place (tie-break order)
            kept = uniq[uniq >= 0]
            assert (np.diff(kept) > 0).all()

    def test_policy_still_migrates(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=500)
        tr = workload.zipf_read_trace(cfg, 2_000, 1.4, seed=2)
        s, _ = run(cfg, tr)
        assert float(s.n_migrated_pages) > 0  # dedup didn't kill the policy
