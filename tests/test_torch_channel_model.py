"""Twin of tests/test_channel_model.py: the port's channel/die/plane timing
lattice (``geometry``'s lattice indexing, ``engine._tandem_departures``,
``ftl._erase_many``'s plane overlap, ``core.faults.block_entity``), held by
the reference's assertions on the CPU with the same seeds, geometries and
hypothesis settings: the tandem recursion against a sequential
per-request reference, the bit-identity of ``chan_model="legacy"`` and of
the degenerate lattice, channel saturation and contention, multi-plane
overlap charges and the faults entity re-keying. The contended lattice run
is held against the JAX package's engine."""

import dataclasses

import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import CPU, check_against_reference, f32, i32, run

from repro_torch.core import faults as flt
from repro_torch.core import modes, retry
from repro_torch.ssdsim import engine, ftl, geometry, workload
from repro_torch.ssdsim import state as st


def _state_identical(sa, sb, exclude=("chan_avail_ms",)):
    """Assert two engine states are bitwise identical, minus ``exclude``.

    ``chan_avail_ms`` is excluded by default: the degenerate lattice still
    tracks the arrival cummax through the (zero-occupancy) channel pass,
    while legacy leaves the clock at 0 — the only tolerated divergence.
    """
    for name, a, b in zip(sa._fields, sa, sb):
        if name in exclude:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert (a == b).all(), name


class TestLatticeIndexing:
    def test_block_to_die_plane_roundtrip(self):
        cfg = geometry.tiny_config(planes_per_lun=2)
        blk = torch.arange(cfg.n_blocks)
        die = cfg.die_of_block(blk).numpy()
        plane = cfg.plane_of_block(blk).numpy()
        assert die.min() == 0 and die.max() == cfg.n_dies - 1
        assert plane.min() == 0 and plane.max() == cfg.planes_per_die - 1
        # die-first striping: consecutive blocks land on consecutive dies,
        # identical to the historical blk % n_luns
        np.testing.assert_array_equal(die, blk.numpy() % cfg.n_luns)
        # every (die, plane) pair holds exactly blocks_per_plane blocks
        slot = cfg.plane_slot_of_block(blk).numpy()
        counts = np.bincount(slot, minlength=cfg.n_dies * cfg.planes_per_die)
        assert (counts == cfg.blocks_per_plane).all()

    def test_channel_of_die_stripes(self):
        cfg = geometry.tiny_config()
        chans = [cfg.channel_of_die(d) for d in range(cfg.n_dies)]
        assert set(chans) == set(range(cfg.n_channels))

    def test_invalid_chan_model_rejected(self):
        with pytest.raises(ValueError, match="chan_model"):
            geometry.tiny_config(chan_model="queueless")


class TestTandemDepartures:
    """The vectorized two-resource recursion against a sequential
    per-request tandem simulation."""

    def _reference(self, die_avail0, chan_avail0, arr, die_occ, xfer, die,
                   chan, rd, active):
        die_avail = np.array(die_avail0, np.float64)
        chan_avail = np.array(chan_avail0, np.float64)
        n = len(arr)
        die_dep = np.zeros(n)
        chan_dep = np.zeros(n)
        for i in range(n):
            if not active[i]:
                die_dep[i] = die_avail[die[i]]
                chan_dep[i] = chan_avail[chan[i]]
                continue
            start = max(arr[i], die_avail[die[i]])
            die_avail[die[i]] = start + die_occ[i]
            die_dep[i] = die_avail[die[i]]
            # transfer eligible at sense end for reads, at arrival for writes
            t_arr = die_dep[i] if rd[i] else arr[i]
            cstart = max(t_arr, chan_avail[chan[i]])
            chan_avail[chan[i]] = cstart + xfer[i]
            chan_dep[i] = chan_avail[chan[i]]
        return die_dep, chan_dep, die_avail, chan_avail

    @settings(max_examples=20, deadline=None)
    @given(seed=st_h.integers(0, 2**16))
    def test_matches_sequential_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, n_dies, n_channels = 64, 4, 2
        arr = np.sort(rng.random(n) * 10.0)
        occ = rng.random(n) * 0.5
        xfer = rng.random(n) * 0.1
        die = rng.integers(0, n_dies, n)
        chan = die % n_channels
        active = rng.random(n) < 0.8
        rd = rng.random(n) < 0.7
        die_avail0 = rng.random(n_dies) * 2.0
        chan_avail0 = rng.random(n_channels) * 2.0
        dd, cd, da, ca = engine._tandem_departures(
            f32(die_avail0), f32(chan_avail0), f32(arr),
            f32(np.where(active, occ, 0.0)), f32(np.where(active, xfer, 0.0)),
            i32(die), i32(chan), torch.as_tensor(rd), torch.as_tensor(active),
            n_dies, n_channels,
        )
        rdd, rcd, rda, rca = self._reference(
            die_avail0, chan_avail0, arr, occ, xfer, die, chan, rd, active
        )
        np.testing.assert_allclose(dd.numpy()[active], rdd[active], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cd.numpy()[active], rcd[active], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(da.numpy(), rda, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ca.numpy(), rca, rtol=1e-4, atol=1e-4)

    def test_infinite_bandwidth_collapses_to_die_pass(self):
        """Zero transfer time: channel departures coincide with die
        departures when each die owns its channel."""
        n_dies = 2
        arr = f32([0.0, 0.1, 0.2, 0.3])
        occ = f32([0.5, 0.5, 0.5, 0.5])
        die = i32([0, 1, 0, 1])
        active = torch.tensor([True] * 4)
        dd, cd, da, ca = engine._tandem_departures(
            torch.zeros(n_dies), torch.zeros(n_dies), arr, occ,
            torch.zeros(4), die, die, torch.tensor([True] * 4),
            active, n_dies, n_dies,
        )
        np.testing.assert_array_equal(dd.numpy(), cd.numpy())
        np.testing.assert_array_equal(da.numpy(), ca.numpy())


class TestLegacyIdentity:
    """The pinned reachability of the old scheduler: legacy mode is the
    default, and the degenerate lattice (1 die/channel, infinite channel
    bandwidth) reproduces it bit for bit on real engine runs."""

    def _traces(self, cfg, seed, rate=None):
        return workload.mixed_trace(
            cfg, 8 * cfg.chunk, theta=1.0, read_frac=0.7, seed=seed,
            arrival_rate=rate,
        )

    @settings(max_examples=4, deadline=None)
    @given(
        seed=st_h.integers(0, 2**16),
        pol=st_h.sampled_from([geometry.BASELINE, geometry.RARO]),
    )
    def test_degenerate_lattice_open_loop_bit_identical(self, seed, pol):
        cfg = geometry.tiny_config(
            n_channels=4, luns_per_channel=1, channel_mb_s=float("inf"),
            policy=pol, initial_pe=500,
        )
        tr = self._traces(cfg, seed, rate=30000.0)
        s_legacy, m_legacy = run(cfg, tr)
        s_lat, m_lat = run(dataclasses.replace(cfg, chan_model="lattice"), tr)
        _state_identical(s_legacy, s_lat)
        np.testing.assert_array_equal(m_legacy.lat_hist.numpy(), m_lat.lat_hist.numpy())
        assert float(s_lat.chanq_sum_ms) == 0.0

    def test_degenerate_lattice_closed_loop_bit_identical(self):
        cfg = geometry.tiny_config(
            n_channels=4, luns_per_channel=1, channel_mb_s=float("inf"),
            policy=geometry.RARO, initial_pe=500,
        )
        tr = self._traces(cfg, seed=7)
        s_legacy, _ = run(cfg, tr)
        s_lat, _ = run(dataclasses.replace(cfg, chan_model="lattice"), tr)
        _state_identical(s_legacy, s_lat)

    def test_lattice_noop_on_closed_loop_any_geometry(self):
        """The closed-loop path runs no queueing code, so legacy and
        lattice agree bitwise even at contended geometry (1 plane)."""
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=500)
        tr = self._traces(cfg, seed=3)
        s_legacy, _ = run(cfg, tr)
        s_lat, _ = run(dataclasses.replace(cfg, chan_model="lattice"), tr)
        _state_identical(s_legacy, s_lat)

    @pytest.fixture(scope="class")
    def contended(self):
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=500)
        tr = self._traces(cfg, seed=3, rate=30000.0)
        s_legacy, _ = run(cfg, tr)
        cfg_lat = dataclasses.replace(cfg, chan_model="lattice")
        s_lat, _ = run(cfg_lat, tr)
        return cfg_lat, tr, s_legacy, s_lat

    def test_contended_lattice_actually_diverges(self, contended):
        """Non-vacuity: at finite bandwidth with dies sharing a channel the
        lattice must differ from legacy (transfer queueing exists)."""
        _, _, s_legacy, s_lat = contended
        assert float(s_lat.chanq_sum_ms) > 0.0
        assert not np.array_equal(s_legacy.lat_hist.numpy(), s_lat.lat_hist.numpy())

    def test_contended_lattice_equals_reference(self, contended):
        cfg_lat, tr, _, s_lat = contended
        check_against_reference(cfg_lat, tr, s_lat)


class TestChannelSaturation:
    """M/G/1-style sanity: with a transfer-dominated channel, 2 dies
    funneling into 1 bus saturate at channel bandwidth, not at 2x die
    bandwidth."""

    def _run(self, mb_s, rate_iops, n=20_000):
        cfg = geometry.tiny_config(
            n_channels=1, luns_per_channel=2, blocks_per_plane=64,
            policy=geometry.BASELINE, initial_pe=0, channel_mb_s=mb_s,
            chan_model="lattice",
        )
        tr = workload.zipf_read_trace(cfg, n, 0.9, seed=5, arrival_rate=rate_iops)
        s, _ = run(cfg, tr)
        return cfg, s, engine.summarize(s, cfg)

    def test_two_dies_one_channel_saturate_at_channel_bandwidth(self):
        # transfer_us = 16384/40.96 = 400 us per page >> QLC sense, so the
        # bus is the bottleneck: read-disturb retries put per-read die
        # service near (1+1.6)*140 = 368 us, so the 2 dies absorb the
        # 4/ms offered rate (~5.4/ms die capacity) but the 2.5/ms channel
        # cannot — the makespan must converge to n_reads * transfer_us
        # (bus at 100% duty), and the wait lives on the channel, not the
        # dies
        cfg, s, m = self._run(mb_s=40.96, rate_iops=4_000.0)
        n = float(s.n_reads)
        chan_limit_ms = n * cfg.transfer_us / 1000.0
        makespan_ms = float(s.chan_avail_ms.max())
        assert makespan_ms == pytest.approx(chan_limit_ms, rel=0.05)
        # the channel-overload wait dwarfs the (stable) die queueing
        assert m["read_chan_wait_us"] > 10.0 * m["read_queue_delay_us"]

    def test_throughput_tracks_offered_load_below_saturation(self):
        # at ~50% channel utilization the bus never backs up much: mean
        # channel wait stays well under one transfer time
        cfg, s, m = self._run(mb_s=40.96, rate_iops=1_250.0)
        assert m["read_chan_wait_us"] < cfg.transfer_us


class TestChannelContention:
    """A 1-channel/multi-die lattice under offered load shows transfer
    queueing — the measured read p99 strictly exceeds the largest possible
    sense + retry + transfer service sum."""

    def test_p99_exceeds_service_bound_under_load(self):
        cfg = geometry.tiny_config(
            n_channels=1, luns_per_channel=4, blocks_per_plane=32,
            policy=geometry.BASELINE, initial_pe=0, chan_model="lattice",
        )
        # BASELINE + pe=0 keeps the retry table static, so the per-slot
        # service bound is exact: (1 + max retries) * t_QLC + transfer
        r = retry.page_retries(
            i32(modes.QLC), i32(cfg.initial_pe), f32(cfg.device_age_h), i32(0),
            torch.arange(cfg.n_slots, dtype=torch.int32),
        ).numpy()
        svc_bound_us = (1.0 + r.max()) * float(
            modes.READ_LATENCY_US[modes.QLC]
        ) + cfg.transfer_us
        tr = workload.zipf_read_trace(cfg, 20_000, 0.9, seed=5, arrival_rate=30_000.0)
        s, _ = run(cfg, tr)
        m = engine.summarize(s, cfg)
        assert m["read_lat_p99_us"] > svc_bound_us
        assert m["read_chan_wait_us"] > 0.0
        # legacy at the same geometry records no transfer queueing at all
        s_leg, _ = run(dataclasses.replace(cfg, chan_model="legacy"), tr)
        m_leg = engine.summarize(s_leg, cfg)
        assert m["read_lat_p99_us"] > m_leg["read_lat_p99_us"]
        assert m_leg["read_chan_wait_us"] == 0.0


class TestMultiPlaneOverlap:
    """Lattice background charging: co-scheduled plane ops on one die pay
    one command + the max of the per-plane times, not the sum."""

    def _erase_two_plane_delta(self, chan_model):
        cfg = geometry.tiny_config(planes_per_lun=2, chan_model=chan_model)
        s = st.init_state(cfg, device=CPU)
        # blocks 0 and n_dies: same die 0, planes 0 and 1
        victims = i32([0, cfg.n_dies])
        grp = torch.ones((2,), dtype=torch.bool)
        before = s.die_busy_ms.numpy().copy()
        s2 = ftl._erase_many(s, victims, grp, cfg)
        return s2.die_busy_ms.numpy() - before, cfg

    def test_two_plane_erase_charges_max_not_sum(self):
        delta_lat, cfg = self._erase_two_plane_delta("lattice")
        delta_leg, _ = self._erase_two_plane_delta("legacy")
        erase_ms = float(modes.ERASE_LATENCY_US[modes.QLC]) / 1000.0
        assert delta_lat[0] == pytest.approx(erase_ms)  # overlapped
        assert delta_leg[0] == pytest.approx(2 * erase_ms)  # serialized
        assert (delta_lat[1:] == 0).all() and (delta_leg[1:] == 0).all()

    def test_single_plane_lattice_charges_match_legacy(self):
        """At planes_per_lun=1 the lattice runs the very same sequential
        charging ops as legacy (no segment-reassociation), keeping the
        degenerate identity bitwise."""
        cfg = geometry.tiny_config(
            policy=geometry.RARO, initial_pe=500, gc_free_threshold=6,
        )
        tr = workload.mixed_trace(cfg, 8 * cfg.chunk, theta=1.0, read_frac=0.5, seed=11)
        s_leg, _ = run(cfg, tr)
        s_lat, _ = run(dataclasses.replace(cfg, chan_model="lattice"), tr)
        np.testing.assert_array_equal(s_leg.die_busy_ms.numpy(), s_lat.die_busy_ms.numpy())

    def test_multi_plane_lattice_run_executes(self):
        """End-to-end smoke at planes_per_lun=2: the lattice run completes
        with background overlap active, and overlapped charging can only
        shrink busy time relative to legacy serialization."""
        cfg = geometry.tiny_config(
            planes_per_lun=2, policy=geometry.RARO, initial_pe=500,
        )
        tr = workload.mixed_trace(cfg, 8 * cfg.chunk, theta=1.0, read_frac=0.5, seed=11)
        s_leg, _ = run(cfg, tr)
        s_lat, _ = run(dataclasses.replace(cfg, chan_model="lattice"), tr)
        assert float(s_lat.n_reads) == float(s_leg.n_reads)
        assert (s_lat.die_busy_ms.numpy() <= s_leg.die_busy_ms.numpy() + 1e-4).all()


class TestFaultsEntity:
    """The erase-fault draw is keyed on the block's lattice coordinates;
    under the striped layout that packs back to the raw block id, so
    zero-rate and legacy draws are pinned unchanged."""

    def test_entity_equals_block_id_under_striping(self):
        for d, p in [(4, 1), (4, 2), (2, 4), (8, 2), (3, 5)]:
            blk = torch.arange(d * p * 7)
            np.testing.assert_array_equal(flt.block_entity(blk, d, p).numpy(), blk.numpy())

    def test_erase_draws_unchanged(self):
        params = flt.FaultParams(
            max_read_retries=i32(-1),
            prog_fail_rate=f32(0.0),
            erase_fail_rate=f32(0.5),
            read_fail_rate=f32(0.0),
            wear_slope=f32(0.0),
            parity_rebuild=i32(0),
            seed=i32(3),
            read_recovery_us=5000.0,
            wear_power=4.0,
        )
        blocks = torch.arange(256, dtype=torch.int32)
        pe = torch.full((256,), 17, dtype=torch.int32)
        rated = torch.full((256,), 3_000, dtype=torch.int32)
        raw = flt.erase_fails(params, blocks, pe, rated).numpy()
        keyed = flt.erase_fails(params, flt.block_entity(blocks, 4, 2), pe, rated).numpy()
        np.testing.assert_array_equal(raw, keyed)
        assert raw.any() and not raw.all()  # the draw is non-trivial

    def test_zero_rate_lattice_run_draws_nothing(self):
        cfg = geometry.tiny_config(
            chan_model="lattice", policy=geometry.RARO, initial_pe=500,
            erase_fail_rate=0.0, prog_fail_rate=0.0, max_read_retries=40,
        )
        tr = workload.mixed_trace(cfg, 6 * cfg.chunk, theta=1.0, read_frac=0.6, seed=2)
        s, _ = run(cfg, tr)
        assert float(s.n_erase_fails) == 0.0
        assert float(s.n_prog_fails) == 0.0
        assert float(s.bad_count) == 0.0
