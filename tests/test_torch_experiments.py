"""The port's experiments subsystem (``repro_torch.experiments``): the twin
of ``tests/test_experiments.py`` (latency-histogram telemetry, scenario
generators, MSR trace replay, the sweep runner) against the port, plus its
parity with the JAX package:

- every registered scenario's trace, and ``parse_msr_csv`` on the bundled
  sample, equal to the reference's bit for bit (both are numpy from the same
  seed), and the port's copy of the sample byte-equal to the reference's;
- the port's ``run_sweep`` (runs one by one) against the reference's
  (vmapped) on three tiny grids — closed loop, open loop over two
  ``arrival_scale`` values, and the fault grid of ``tests/test_faults.py`` —
  by ``tests/torch_ssd_compare.py``'s rule: count-valued results exact,
  float results rtol 1e-5, and the same ``"run"`` metadata in the same
  order.
"""

import json

import numpy as np
import pytest
import torch
from torch_ssd_compare import compare_summaries

from repro_torch.experiments import registry, scenarios, sweep, traces
from repro_torch.ssdsim import engine, geometry, telemetry, workload
from repro_torch.ssdsim.engine import OP_READ, OP_WRITE

TINY = geometry.tiny_config()
CPU = "cpu"


class TestTelemetry:
    def test_bin_edges_monotone_log_spaced(self):
        e = telemetry.bin_edges_us()
        assert e.shape == (telemetry.N_LAT_BINS + 1,)
        ratios = e[1:] / e[:-1]
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-9)

    def test_latency_bin_brackets_edges(self):
        e = telemetry.bin_edges_us()
        # values inside bin i land in bin i; extremes clip
        mids = np.sqrt(e[:-1] * e[1:])
        idx = telemetry.latency_bin(torch.tensor(mids, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(idx, np.arange(telemetry.N_LAT_BINS))
        assert int(telemetry.latency_bin(torch.tensor(1e-3))) == 0
        assert int(telemetry.latency_bin(torch.tensor(1e9))) == telemetry.N_LAT_BINS - 1

    def test_record_masks_and_counts(self):
        h = torch.zeros((telemetry.N_LAT_BINS,), dtype=torch.float32)
        lat = torch.tensor([20.0, 140.0, 2000.0, 99.0])
        mask = torch.tensor([True, True, True, False])
        h = telemetry.record(h, lat, mask)
        assert float(h.sum()) == 3.0

    def test_percentiles_match_numpy_on_synthetic_sample(self):
        rng = np.random.default_rng(0)
        lat = np.exp(rng.normal(np.log(200.0), 0.8, size=200_000))
        h = np.zeros(telemetry.N_LAT_BINS)
        idx = telemetry.latency_bin(torch.tensor(lat, dtype=torch.float32)).numpy()
        np.add.at(h, idx, 1.0)
        pct = telemetry.percentiles(h)
        for q in (0.5, 0.95, 0.99):
            exact = np.quantile(lat, q)
            assert abs(pct[q] - exact) / exact < 0.10, (q, pct[q], exact)

    def test_empty_histogram(self):
        pct = telemetry.percentiles(np.zeros(telemetry.N_LAT_BINS))
        assert all(v == 0.0 for v in pct.values())

    def test_single_bin_histogram_stays_in_bin(self):
        """All mass in one bin: every quantile must interpolate inside that
        bin's edges, never land in a neighboring empty bin."""
        edges = telemetry.bin_edges_us()
        for b in (0, 17, telemetry.N_LAT_BINS - 1):
            h = np.zeros(telemetry.N_LAT_BINS)
            h[b] = 7.0
            pct = telemetry.percentiles(h, qs=(0.5, 0.95, 0.999, 1.0))
            for q, v in pct.items():
                # 1-ulp slack: lo * (hi/lo)**1.0 re-rounds the upper edge
                assert edges[b] * (1 - 1e-12) <= v <= edges[b + 1] * (1 + 1e-12), (b, q, v)

    def test_exact_boundary_quantile(self):
        """Target count falling exactly on a cumulative boundary (q=0.5 of
        [2, 0, 2]) must resolve at the boundary, not inside the empty bin."""
        edges = telemetry.bin_edges_us()
        h = np.zeros(telemetry.N_LAT_BINS)
        h[0], h[2] = 2.0, 2.0
        pct = telemetry.percentiles(h, qs=(0.5,))
        assert pct[0.5] <= edges[1] * (1 + 1e-9)
        # monotone across the empty gap
        pct2 = telemetry.percentiles(h, qs=(0.5, 0.75, 0.999))
        assert pct2[0.5] <= pct2[0.75] <= pct2[0.999] <= edges[3]

    def test_target_overshoot_does_not_hit_empty_tail_bin(self):
        """q slightly above 1 overshoots the last cumulative count: the
        quantile must clamp to the last non-empty bin instead of
        interpolating inside the empty tail."""
        h = np.zeros(telemetry.N_LAT_BINS)
        h[:20] = 1.0  # empty tail from bin 20 on
        edges = telemetry.bin_edges_us()
        for q in (1.0, 1.0 + 1e-9):  # boundary + guaranteed overshoot
            pct = telemetry.percentiles(h, qs=(q,))
            assert pct[q] <= edges[20] * (1 + 1e-9), (q, pct[q])

    def test_engine_histogram_totals_reads(self):
        tr = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=0)
        s, ys = engine.run(TINY, tr, device=CPU)
        assert float(s.lat_hist.sum()) == float(s.n_reads)
        # per-chunk histograms sum to the cumulative one
        np.testing.assert_allclose(ys.lat_hist.numpy().sum(0), s.lat_hist.numpy(), rtol=1e-6)

    def test_summarize_percentiles_ordered(self):
        tr = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=0)
        s, _ = engine.run(TINY, tr, device=CPU)
        m = engine.summarize(s, TINY)
        assert (m["read_lat_p50_us"] <= m["read_lat_p95_us"]
                <= m["read_lat_p99_us"] <= m["read_lat_p999_us"])
        assert m["read_lat_p50_us"] > 0


class TestScenarios:
    @pytest.mark.parametrize("name", ["hotspot_shift", "bursty", "diurnal",
                                      "write_burst_then_read",
                                      "read_disturb_hammer"])
    def test_shapes_range_and_determinism(self, name):
        a = registry.build(name, TINY, 3_000, seed=5)
        b = registry.build(name, TINY, 3_000, seed=5)
        assert a["lpn"].shape == a["op"].shape
        assert a["lpn"].shape[1] == TINY.chunk
        lpn = a["lpn"].reshape(-1)
        assert lpn.max() < TINY.n_logical and lpn.min() >= -1
        np.testing.assert_array_equal(a["lpn"], b["lpn"])
        np.testing.assert_array_equal(a["op"], b["op"])

    def test_unknown_scenario_raises(self):
        with pytest.raises(KeyError):
            registry.build("no_such_scenario", TINY, 100)

    def test_read_disturb_hammer_concentrates_reads(self):
        tr = scenarios.read_disturb_hammer(TINY, 8_000, seed=0, hammer_prob=0.8)
        lpn = tr["lpn"].reshape(-1)
        lpn = lpn[lpn >= 0]
        counts = np.bincount(lpn // TINY.slots_per_block, minlength=TINY.n_blocks)
        # >= 70% of reads land on the ~2 hammered blocks
        assert np.sort(counts)[-3:].sum() > 0.7 * len(lpn)

    def test_write_burst_then_read_phase_order(self):
        tr = scenarios.write_burst_then_read(TINY, 4_000, seed=0, write_frac=0.25)
        op = tr["op"].reshape(-1)[:4_000]
        n_w = int((op == OP_WRITE).sum())
        assert n_w == 1_000
        assert (op[:n_w] == OP_WRITE).all() and (op[n_w:] == OP_READ).all()

    def test_hotspot_shift_moves(self):
        tr = scenarios.hotspot_shift(TINY, 8_000, seed=0, n_phases=2,
                                     hot_frac=0.05, hot_prob=1.0)
        lpn = tr["lpn"].reshape(-1)[:8_000]
        assert np.median(lpn[:4_000]) != np.median(lpn[4_000:])


class TestTraceReplay:
    def test_parse_sample(self):
        rec = traces.parse_msr_csv(traces.SAMPLE_TRACE)
        assert len(rec["op"]) > 400
        assert set(np.unique(rec["op"])) <= {OP_READ, OP_WRITE}
        assert (rec["size"] > 0).all() and (rec["offset"] >= 0).all()
        assert (np.diff(rec["timestamp"]) >= 0).all()  # sorted

    def test_header_and_garbage_tolerated(self, tmp_path):
        p = tmp_path / "t.csv"
        p.write_text(
            "Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime\n"
            "1000,h,0,Read,32768,32768,100\n"
            "not,a,valid,row\n"
            "2000,h,0,Write,0,16384,50\n"
        )
        rec = traces.parse_msr_csv(p)
        assert len(rec["op"]) == 2
        np.testing.assert_array_equal(rec["op"], [OP_READ, OP_WRITE])

    def test_page_expansion_and_wrap(self):
        rec = {
            "timestamp": np.array([0, 1], np.int64),
            "op": np.array([OP_READ, OP_WRITE], np.int32),
            # 2nd I/O straddles a page boundary -> 3 pages
            "offset": np.array([0, 16 * 1024 + 8192], np.int64),
            "size": np.array([16 * 1024, 2 * 16 * 1024], np.int64),
        }
        lpn, op, arr = traces.records_to_page_requests(TINY, rec)
        assert len(lpn) == 1 + 3
        assert (op == [OP_READ, OP_WRITE, OP_WRITE, OP_WRITE]).all()
        np.testing.assert_array_equal(lpn, [0, 1, 2, 3])
        # every page of an I/O inherits its arrival time (filetime ticks
        # rebased to ms: 1 tick = 100 ns = 1e-4 ms)
        np.testing.assert_allclose(arr, [0.0, 1e-4, 1e-4, 1e-4])

    def test_replay_end_to_end(self):
        tr = registry.build("msr_sample", TINY, 2_000, seed=0)
        s, _ = engine.run(TINY, tr, device=CPU)
        assert float(s.n_reads) + float(s.n_writes) == 2_000
        assert float(s.n_writes) > 0  # sample contains a write burst
        assert (s.l2p.numpy() >= 0).all()

    def test_cycle_fills_budget(self):
        tr = traces.replay_trace(TINY, traces.SAMPLE_TRACE, n_requests=10_000)
        lpn = tr["lpn"].reshape(-1)
        assert (lpn[:10_000] >= 0).all()


def _spec(**kw):
    d = dict(
        scenario="read_disturb_hammer",
        n_requests=4_000,
        policies=(geometry.BASELINE, geometry.RARO),
        initial_pe=(166, 833),
        seeds=(0, 1),
        base=TINY,
    )
    d.update(kw)
    return sweep.SweepSpec(**d)


@pytest.fixture(scope="module")
def grid():
    """The port's results on TestSweep's grid, shared by the tests that only
    read them."""
    return sweep.run_sweep(_spec(), device=CPU)


class TestSweep:
    def test_expand_cross_product(self):
        spec = _spec(r2_override=(-1, 7))
        runs = sweep.expand(spec)
        assert len(runs) == spec.n_runs() == 16
        assert len({r.tag() for r in runs}) == 16

    def test_grid_results_and_tail_ordering(self, grid):
        res = grid
        assert len(res) == 8
        for r in res:
            assert r["read_lat_p50_us"] <= r["read_lat_p99_us"]
            assert r["reads"] == 4_000
        # sweep run == engine.run: baseline pe833 seed0
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=833)
        tr = registry.build("read_disturb_hammer", TINY, 4_000, seed=0)
        s, _ = engine.run(cfg, tr, device=CPU)
        single = engine.summarize(s, cfg)
        swept = [r for r in res if r["run"]["tag"]
                 == "read_disturb_hammer_baseline_pe833_seed0"][0]
        np.testing.assert_allclose(
            swept["mean_read_latency_us"], single["mean_read_latency_us"], rtol=1e-4,
        )

    def test_raro_beats_baseline_p99_on_hammer(self, grid):
        by = {r["run"]["tag"]: r for r in grid}
        for pe in (166, 833):
            b = by[f"read_disturb_hammer_baseline_pe{pe}_seed0"]
            r = by[f"read_disturb_hammer_raro_pe{pe}_seed0"]
            assert r["read_lat_p99_us"] < b["read_lat_p99_us"], pe
            assert r["mean_read_latency_us"] < b["mean_read_latency_us"], pe

    def test_r2_override_changes_behavior(self):
        spec = _spec(policies=(geometry.RARO,), initial_pe=(833,),
                     seeds=(0,), r2_override=(-1, 2))
        res = sweep.run_sweep(spec, device=CPU)
        migrated = [r["migrated_pages"] for r in res]
        # aggressive R2=2 must migrate at least as much as the stage schedule
        assert migrated[1] >= migrated[0]

    def test_artifacts_roundtrip(self, tmp_path):
        res = sweep.run_sweep(_spec(policies=(geometry.RARO,), initial_pe=(500,), seeds=(0,)),
                              device=CPU)
        paths = sweep.write_artifacts(res, tmp_path)
        assert len(paths) == 1 and paths[0].name.startswith("BENCH_sweep_")
        doc = json.loads(paths[0].read_text())
        assert doc["run"]["policy"] == "raro"
        assert doc["metrics"]["read_lat_p99_us"] == pytest.approx(res[0]["read_lat_p99_us"])
        names = [r[0] for r in doc["rows"]]
        assert any(n.endswith("read_lat_p99_us") for n in names)

    def test_seed_invariant_scenario_warns_on_multi_seed(self):
        spec = _spec(scenario="msr_sample", n_requests=1_000,
                     policies=(geometry.BASELINE,), initial_pe=(166,), seeds=(0, 1))
        with pytest.warns(UserWarning, match="deterministic w.r.t. seed"):
            sweep.run_sweep(spec, device=CPU)

    def test_msr_scenario_usable_from_sweep(self):
        spec = _spec(scenario="msr_sample", n_requests=2_000,
                     policies=(geometry.RARO,), initial_pe=(500,), seeds=(0,))
        res = sweep.run_sweep(spec, device=CPU)
        assert len(res) == 1
        assert res[0]["writes"] > 0
        assert res[0]["run"]["scenario"] == "msr_sample"


# --------------------------- parity with the reference ---------------------


def _j_cfg(cfg):
    """The reference's SimConfig with every field of the port's."""
    import dataclasses

    from repro.core import hotness as j_hot
    from repro.ssdsim import geometry as j_geo

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["heat"] = j_hot.HeatConfig(*fields["heat"])
    return j_geo.SimConfig(**fields)


def _assert_traces_equal(ref, out):
    assert set(ref) == set(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype, k
        np.testing.assert_array_equal(ref[k], out[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(registry.SCENARIOS))
def test_scenario_trace_equals_reference(name):
    from repro.experiments import registry as j_reg

    assert registry.names() == j_reg.names()
    for n, seed in ((3_000, 5), (1_000, 0)):
        _assert_traces_equal(j_reg.build(name, _j_cfg(TINY), n, seed=seed),
                             registry.build(name, TINY, n, seed=seed))


def test_table3_grid_traces_equal_reference():
    """The traces of ``raro_ssd.tail_latency_sweep()``'s grid (Table III
    geometry, 80,000 requests, seeds 0 and 1), which chip_smoke.py runs."""
    from repro.configs import raro_ssd as j_raro
    from repro.experiments import registry as j_reg

    from repro_torch.configs import raro_ssd

    spec, j_spec = raro_ssd.tail_latency_sweep(), j_raro.tail_latency_sweep()
    assert _j_cfg(spec.base) == j_spec.base
    for seed in spec.seeds:
        _assert_traces_equal(
            j_reg.build(j_spec.scenario, j_spec.base, j_spec.n_requests, seed=seed),
            registry.build(spec.scenario, spec.base, spec.n_requests, seed=seed))


def test_msr_sample_equals_reference():
    from repro.experiments import traces as j_tr

    assert traces.SAMPLE_TRACE.read_bytes() == j_tr.SAMPLE_TRACE.read_bytes()
    assert traces.SAMPLE_TRACE != j_tr.SAMPLE_TRACE  # the port's own copy
    ref, out = j_tr.parse_msr_csv(j_tr.SAMPLE_TRACE), traces.parse_msr_csv(traces.SAMPLE_TRACE)
    _assert_traces_equal(ref, out)
    _assert_traces_equal(j_tr.replay_trace(_j_cfg(TINY), j_tr.SAMPLE_TRACE, n_requests=10_000),
                         traces.replay_trace(TINY, traces.SAMPLE_TRACE, n_requests=10_000))


def test_presets_equal_reference():
    from repro.configs import raro_ssd as j_raro
    from repro.experiments import sweep as j_sweep

    from repro_torch.configs import raro_ssd

    assert raro_ssd.STAGE_PE == j_raro.STAGE_PE
    for k in ("YOUNG", "MIDDLE", "OLD"):
        assert _j_cfg(getattr(raro_ssd, k)) == getattr(j_raro, k)
    for fn in ("tail_latency_sweep", "sharded_sweep", "fault_storm_sweep", "endurance_sweep",
               "wearout_sweep", "latency_load_sweep"):
        spec, j_spec = getattr(raro_ssd, fn)(), getattr(j_raro, fn)()
        assert _j_cfg(spec.base) == j_spec.base, fn
        assert ({k: v for k, v in vars(spec).items() if k != "base"}
                == {k: v for k, v in vars(j_spec).items() if k != "base"}), fn
        assert [r.tag() for r in sweep.expand(spec)] == [r.tag() for r in j_sweep.expand(j_spec)]


def _fault_spec(**kw):
    d = dict(
        scenario="fault_storm", n_requests=2_048,
        policies=(geometry.BASELINE, geometry.RARO),
        initial_pe=(900,), seeds=(0,),
        prog_fail_rate=(0.0, 0.02), erase_fail_rate=(0.05,),
        max_read_retries=(6,), base=TINY,
    )
    d.update(kw)
    return sweep.SweepSpec(**d)


SWEEP_GRIDS = {
    "closed": _spec,
    "open_loop": lambda: _spec(scenario="hammer_openloop", n_requests=2_048,
                               initial_pe=(500,), seeds=(0,), arrival_scale=(0.5, 2.0),
                               scenario_kw=(("rate_iops", 20_000.0),)),
    "faults": _fault_spec,
}


@pytest.mark.parametrize("grid_name", sorted(SWEEP_GRIDS))
def test_run_sweep_matches_reference(grid_name, grid):
    from repro.experiments import sweep as j_sweep

    spec = SWEEP_GRIDS[grid_name]()
    j_spec = j_sweep.SweepSpec(**{**vars(spec), "base": _j_cfg(spec.base)})
    ref = j_sweep.run_sweep(j_spec)
    out = grid if grid_name == "closed" else sweep.run_sweep(spec, device=CPU)
    assert [r["run"] for r in out] == [r["run"] for r in ref]
    for a, b in zip(ref, out):
        bad = compare_summaries({k: v for k, v in a.items() if k != "run"},
                                {k: v for k, v in b.items() if k != "run"})
        assert not bad, (a["run"]["tag"], bad)
    json.dumps(out)  # plain floats and lists only
    if grid_name == "open_loop":
        assert all(r["read_queue_delay_us"] > 0 for r in out)
    if grid_name == "faults":
        assert any(r["prog_fails"] > 0 for r in out)
        assert all(r["uncorrectable_reads"] > 0 for r in out)
