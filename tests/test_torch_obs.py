"""Twin of tests/test_obs.py: the port's observability layer
(``repro_torch.ssdsim.obs``) held by the reference's assertions on the CPU,
with the same seeds, sizes and hypothesis settings: latency attribution,
the conversion event ring, windowed time series, levels and summarize
(the Chrome trace and the sweep integration have their twins in
test_torch_trace_export.py and test_torch_sweep.py). The mixed run is held
against the JAX package's engine."""

import json

import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import CPU, check_against_reference, f32, run

from repro_torch.core import modes
from repro_torch.ssdsim import engine, geometry, obs, state as st, telemetry, workload


def _full_cfg(**kw):
    base = dict(policy=geometry.RARO, initial_pe=500, obs_level="full",
                obs_event_capacity=4096, obs_windows=32, obs_window_ms=5.0)
    base.update(kw)
    return geometry.tiny_config(**base)


def _mixed_trace(cfg):
    return workload.mixed_trace(cfg, 16 * cfg.chunk, theta=1.0, read_frac=0.7, seed=3)


@pytest.fixture(scope="module")
def mixed_run():
    """One tiny mixed closed-loop run with every instrument on."""
    cfg = _full_cfg()
    s, _ = run(cfg, _mixed_trace(cfg))
    return cfg, s


def test_mixed_run_equals_reference(mixed_run):
    cfg, s = mixed_run
    check_against_reference(cfg, _mixed_trace(cfg), s)


@pytest.fixture(scope="module")
def open_run():
    """Same workload under the open-loop arrival model (queue component)."""
    cfg = _full_cfg()
    tr = workload.mixed_trace(cfg, 16 * cfg.chunk, theta=1.0, read_frac=0.7,
                              seed=3, arrival_rate=8000.0)
    s, _ = run(cfg, tr)
    return cfg, s


@pytest.fixture(scope="module")
def lattice_run():
    """Open-loop run under the lattice channel model on a single shared bus
    (1 channel x 4 dies): the chan_wait component actually fires."""
    cfg = _full_cfg(n_channels=1, luns_per_channel=4, chan_model="lattice")
    tr = workload.mixed_trace(cfg, 16 * cfg.chunk, theta=1.0, read_frac=0.9,
                              seed=3, arrival_rate=30000.0)
    s, _ = run(cfg, tr)
    return cfg, s


class TestLatencyAttribution:
    def test_per_mode_hist_sums_to_lat_hist_bit_exact(self, mixed_run):
        cfg, s = mixed_run
        assert np.array_equal(np.asarray(s.obs_lat_mode).sum(axis=0),
                              np.asarray(s.lat_hist))

    def test_open_loop_hist_sums_bit_exact(self, open_run):
        cfg, s = open_run
        assert np.array_equal(np.asarray(s.obs_lat_mode).sum(axis=0),
                              np.asarray(s.lat_hist))

    def test_mode_counts_cover_all_reads(self, mixed_run):
        cfg, s = mixed_run
        assert np.asarray(s.obs_lat_mode).sum() == float(s.n_reads) > 0

    def test_components_sum_to_recorded_latency(self, open_run):
        """Per (mode, bin), the four component µs together reconstruct the
        total recorded latency mass binned there (queue + sense + retry
        penalty + transfer is the recorded latency, by construction)."""
        cfg, s = open_run
        comp = np.asarray(s.obs_lat_comp, np.float64)
        counts = np.asarray(s.obs_lat_mode, np.float64)
        total_us = comp.sum(axis=1)  # (modes, bins)
        lo = telemetry.bin_edges_us()[:-1]
        hi = telemetry.bin_edges_us()[1:]
        # mass in each bin must lie within the bin's edge bounds x count
        # (first/last bins are clipped, so only check the interior)
        inner = slice(1, telemetry.N_LAT_BINS - 1)
        assert (
            total_us[:, inner] >= counts[:, inner] * lo[inner] * 0.999
        ).all()
        assert (
            total_us[:, inner] <= counts[:, inner] * hi[inner] * 1.001
        ).all()

    def test_closed_loop_queue_component_is_zero(self, mixed_run):
        cfg, s = mixed_run
        assert np.asarray(s.obs_lat_comp)[:, obs.COMP_QUEUE].sum() == 0.0

    def test_open_loop_queue_component_positive(self, open_run):
        cfg, s = open_run
        assert np.asarray(s.obs_lat_comp)[:, obs.COMP_QUEUE].sum() > 0.0

    def test_legacy_chan_wait_component_is_zero(self, open_run):
        """Under chan_model="legacy" transfer never queues, so the
        chan_wait component carries no mass (closed-loop likewise)."""
        cfg, s = open_run
        assert np.asarray(s.obs_lat_comp)[:, obs.COMP_CHANWAIT].sum() == 0.0

    def test_closed_loop_chan_wait_component_is_zero(self, mixed_run):
        cfg, s = mixed_run
        assert np.asarray(s.obs_lat_comp)[:, obs.COMP_CHANWAIT].sum() == 0.0

    def test_lattice_chan_wait_component_positive(self, lattice_run):
        """4 dies funneling into one bus under offered load: some reads
        must wait for the channel, and the wait is attributed."""
        cfg, s = lattice_run
        assert np.asarray(s.obs_lat_comp)[:, obs.COMP_CHANWAIT].sum() > 0.0

    def test_lattice_hist_sums_bit_exact(self, lattice_run):
        cfg, s = lattice_run
        assert np.array_equal(np.asarray(s.obs_lat_mode).sum(axis=0),
                              np.asarray(s.lat_hist))

    def test_lattice_components_sum_to_recorded_latency(self, lattice_run):
        """The five components (queue + sense + retry + chan_wait +
        transfer) still reconstruct the binned latency mass under the
        tandem model."""
        cfg, s = lattice_run
        comp = np.asarray(s.obs_lat_comp, np.float64)
        counts = np.asarray(s.obs_lat_mode, np.float64)
        total_us = comp.sum(axis=1)
        lo = telemetry.bin_edges_us()[:-1]
        hi = telemetry.bin_edges_us()[1:]
        inner = slice(1, telemetry.N_LAT_BINS - 1)
        assert (
            total_us[:, inner] >= counts[:, inner] * lo[inner] * 0.999
        ).all()
        assert (
            total_us[:, inner] <= counts[:, inner] * hi[inner] * 1.001
        ).all()

    def test_tail_attribution_shares_normalized(self, mixed_run):
        cfg, s = mixed_run
        att = obs.tail_attribution(s, cfg)
        for name in modes.MODE_NAMES:
            shares = att[name]["component_share"]
            if att[name]["tail_reads"] > 0:
                assert sum(shares.values()) == pytest.approx(1.0)


class TestEventRing:
    def test_decoded_matrix_equals_n_conversions(self, mixed_run):
        cfg, s = mixed_run
        records, total, dropped = obs.decode_events(s, cfg)
        assert dropped == 0
        mat = obs.event_conversion_matrix(records)
        assert np.array_equal(mat, np.asarray(s.n_conversions))
        assert mat.sum() > 0  # the run actually converted something

    def test_event_fields_in_range(self, mixed_run):
        cfg, s = mixed_run
        records, _, _ = obs.decode_events(s, cfg)
        for r in records:
            assert 0 <= r["from_mode"] < modes.N_MODES
            assert 0 <= r["to_mode"] < modes.N_MODES
            assert r["reason_name"] in obs.REASON_NAMES
            assert r["pages"] >= 0 and r["retry_est"] >= 0
            assert -1 <= r["block"] < cfg.n_blocks

    @settings(max_examples=25, deadline=None)
    @given(
        cap=st_h.integers(1, 9),
        batches=st_h.lists(
            st_h.lists(st_h.booleans(), min_size=1, max_size=6),
            min_size=0, max_size=8,
        ),
    )
    def test_overwrite_oldest_property(self, cap, batches):
        """The ring always holds the most recent ``min(total, cap)`` events
        in emission order, and the counter keeps the exact total."""
        cfg = geometry.tiny_config(obs_level="full", obs_event_capacity=cap)
        s = st.init_state(cfg, device=CPU)
        expected = []
        n = 0
        for mask in batches:
            k = len(mask)
            vals = np.arange(n, n + k, dtype=np.float32)
            s = obs.record_events(
                s, cfg, mask=torch.tensor(mask), block=f32(vals),
                from_mode=torch.zeros(k), to_mode=torch.ones(k),
                reason=obs.REASON_GC, retry_est=torch.zeros(k), pages=f32(vals),
            )
            expected += [float(v) for v, m in zip(vals, mask) if m]
            n += k
        records, total, dropped = obs.decode_events(s, cfg)
        assert total == len(expected)
        assert dropped == max(total - cap, 0)
        assert [r["pages"] for r in records] == [
            int(v) for v in expected[-min(total, cap):]
        ]

    def test_truncation_is_explicit(self):
        """Overflowing the ring keeps the true total and reports dropped."""
        cfg = _full_cfg(obs_event_capacity=8)
        tr = workload.mixed_trace(cfg, 16 * cfg.chunk, theta=1.0,
                                  read_frac=0.7, seed=3)
        s, _ = run(cfg, tr)
        records, total, dropped = obs.decode_events(s, cfg)
        assert len(records) == min(total, 8)
        assert dropped == total - len(records)
        assert dropped > 0  # the mixed run emits more than 8 events


class TestTimeSeries:
    def test_series_sums_match_totals(self, mixed_run):
        cfg, s = mixed_run
        ts = obs.decode_timeseries(s, cfg)
        assert ts["reads"].sum() == float(s.n_reads)
        assert ts["retries"].sum() == float(s.n_retries)
        assert ts["writes"].sum() == float(s.n_writes)
        assert ts["conversions"].sum() == float(
            np.asarray(s.n_conversions).sum()
        )
        assert ts["erases"].sum() == float(s.n_erases)
        assert ts["migrated_pages"].sum() == float(s.n_migrated_pages)

    def test_open_loop_queue_series_positive(self, open_run):
        cfg, s = open_run
        ts = obs.decode_timeseries(s, cfg)
        assert ts["queue_ms"].sum() > 0
        assert ts["reads"].sum() == float(s.n_reads)


class TestLevelsAndSummarize:
    def test_off_leaves_are_empty(self):
        cfg = geometry.tiny_config()
        s = st.init_state(cfg, device=CPU)
        assert s.obs_lat_mode.shape[0] == 0
        assert s.obs_lat_comp.shape[0] == 0
        assert s.obs_events.shape[0] == 0
        assert s.obs_ts.shape[0] == 0

    def test_off_summarize_has_no_obs_keys(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=500)
        tr = workload.mixed_trace(cfg, 2 * cfg.chunk, theta=1.0, seed=0)
        s, _ = run(cfg, tr)
        m = engine.summarize(s, cfg)
        assert not any(
            k.startswith(("lat_mode", "lat_attrib", "obs_", "tail_",
                          "conversion_events"))
            for k in m
        )

    def test_counters_level_histograms_only(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=500,
                                   obs_level="counters")
        tr = workload.mixed_trace(cfg, 4 * cfg.chunk, theta=1.0, seed=0)
        s, _ = run(cfg, tr)
        assert np.array_equal(np.asarray(s.obs_lat_mode).sum(axis=0),
                              np.asarray(s.lat_hist))
        assert s.obs_lat_comp.shape[0] == 0 and s.obs_events.shape[0] == 0
        m = engine.summarize(s, cfg)
        assert "lat_mode_counts" in m and "lat_attrib_us" not in m

    def test_invalid_level_rejected(self):
        with pytest.raises(ValueError, match="obs_level"):
            st.init_state(geometry.tiny_config(obs_level="everything"), device=CPU)

    def test_summarize_event_matrix_matches(self, mixed_run):
        cfg, s = mixed_run
        m = engine.summarize(s, cfg)
        assert m["obs_events_dropped"] == 0.0
        assert np.array_equal(np.asarray(m["conversion_events"]),
                              np.asarray(m["conversions"]))

    def test_summarize_json_round_trip(self, mixed_run):
        """Satellite: the full summarize dict (ndarray-free) survives a JSON
        round trip unchanged."""
        cfg, s = mixed_run
        m = engine.summarize(s, cfg)
        back = json.loads(json.dumps(m))
        assert back == m  # floats/lists only -> exact round trip


# ---------------------------------------------------------------------------
# record_reads itself against the reference's, on the same lanes
# ---------------------------------------------------------------------------

def _read_lanes(cfg, seed, clock):
    """One chunk of read lanes drawn by numpy: modes (one out of range),
    a read mask, latencies of mixed magnitudes and their components,
    retries, uncorrectable flags, and each lane's time: the chunk's one
    clock (closed loop: every read in one window) or departures spread over
    a few windows (open loop)."""
    rng = np.random.default_rng(seed)
    n = cfg.chunk
    us = lambda: (10.0 ** rng.uniform(0.5, 4.5, n)).astype(np.float32)  # noqa: E731
    mode = rng.integers(0, modes.N_MODES, n).astype(np.int32)
    mode[3] = modes.N_MODES + 1
    # open loop: sorted departures over about three windows
    w = cfg.obs_window_ms
    t_ms = (np.full(n, clock) if clock is not None
            else np.sort(rng.uniform(0.4 * w, 3.4 * w, n))).astype(np.float32)
    return dict(mode=mode, rd=rng.random(n) < 0.85, lat_us=us(), queue_us=us(), sense_us=us(),
                retry_us=us(), chanw_us=us(), xfer_us=us(),
                retries=rng.integers(0, 6, n).astype(np.int32), t_ms=t_ms,
                uncorr=rng.random(n) < 0.05, rebuild_us=us())


@pytest.mark.parametrize("level", ["full", "counters"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_record_reads_equals_the_references(level, loop):
    """``obs.record_reads`` on the CPU bit for bit the reference's (jitted,
    as its engine runs it) on the same lanes and the same nonzero
    accumulators: the per-mode histogram, the time series and, at "full",
    the component sums (with the rebuild component in the closed loop,
    without it in the open one)."""
    import jax
    import jax.numpy as jnp
    from repro.ssdsim import obs as j_obs
    from repro.ssdsim import state as j_st
    from torch_twins import reference_config

    cfg = _full_cfg(obs_level=level, obs_windows=16)
    j_cfg = reference_config(cfg)
    lanes = _read_lanes(cfg, 17 if loop == "closed" else 18,
                        3.3 * cfg.obs_window_ms if loop == "closed" else None)
    if loop == "open":
        lanes.pop("rebuild_us")
    rng = np.random.default_rng(19)
    s = st.init_state(cfg, device=CPU)
    acc = {k: (rng.standard_normal(tuple(getattr(s, k).shape)) * 1e3).astype(np.float32)
           for k in ("obs_ts", "obs_lat_comp")}
    s = s._replace(**{k: torch.from_numpy(v) for k, v in acc.items()})
    js = j_st.init_state(j_cfg)._replace(**{k: jnp.asarray(v) for k, v in acc.items()})
    got = obs.record_reads(s, cfg, **{k: torch.from_numpy(v) for k, v in lanes.items()})
    want = jax.jit(lambda js_, kw: j_obs.record_reads(js_, j_cfg, **kw))(
        js, {k: jnp.asarray(v) for k, v in lanes.items()})
    for leaf in ("obs_lat_mode", "obs_ts", "obs_lat_comp"):
        np.testing.assert_array_equal(getattr(got, leaf).numpy(), np.asarray(getattr(want, leaf)),
                                      err_msg=leaf)
    assert got.obs_lat_comp.is_contiguous()
    if loop == "closed":  # every read in window 3: its row takes them all
        added = got.obs_ts[:, obs.TS_READS].double() - s.obs_ts[:, obs.TS_READS].double()
        assert round(float(added[3])) == int(lanes["rd"].sum()) and float(added.abs().sum()) == \
            pytest.approx(float(added[3]))
