"""Twin of tests/test_wearout.py: the port's wear-correlated fault model,
die-parity rebuild, spare pool, youngest-first allocation and windowed WAF
(``repro_torch.core.faults``, the engine's recovery paths,
``ftl.alloc_free_block``, ``obs``), held by the reference's assertions on
the CPU with the same seeds, sizes and hypothesis settings. Where the
reference batches runs through ``sweep._sweep_jit``, the twin runs each
with ``sweep.run_one`` (``torch_twins.knob_runs``). The parity-rebuild run
is held against the JAX package's engine.

Four things are pinned here:

  1. The wear curve itself — ``rate * (1 + slope * (pe/rated)^power)`` is
     monotone in P/E, matches the analytic curve empirically, and with
     ``slope == 0`` is *exactly* the flat rate (multiplier bit-equal to
     1.0, so the draw comparison is unchanged).
  2. Knob-vs-static neutrality: a run whose knob fields (read-fail rate,
     wear slope, parity, spare pool) are explicit neutral values is
     bit-identical to one where they are ``None`` and fall back to the
     static config.
  3. Die-parity rebuild: uncorrectable reads trigger stripe reconstruction
     (counted, latency-attributed to its own component, histogram mass
     conserved) and a second peer fault during the rebuild is data loss.
  4. Spare-pool degradation: retirements drain the pool, exhaustion flips
     the device read-only (writes dropped and counted) and the mapping
     stays coherent throughout — including under random fault schedules.
"""

import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import CPU, check_against_reference, i32, knob_runs, pressure_cfg, run
from torch_twins import mixed as _mixed

from repro_torch.core import faults
from repro_torch.ssdsim import engine, ftl, geometry, obs, policies, state as st, workload

TINY = geometry.tiny_config()


def _params(**kw):
    d = dict(max_read_retries=np.int32(-1),
             prog_fail_rate=np.float32(0.0), erase_fail_rate=np.float32(0.0),
             read_fail_rate=np.float32(0.0), wear_slope=np.float32(0.0),
             parity_rebuild=np.int32(0), seed=np.int32(1),
             read_recovery_us=5_000.0, wear_power=4.0)
    d.update(kw)
    return faults.FaultParams(**{k: v if isinstance(v, float) else torch.tensor(v)
                                 for k, v in d.items()})


# ------------------------------- wear curve --------------------------------


class TestWearCurve:
    def test_zero_slope_multiplier_is_exactly_one(self):
        p = _params(wear_slope=np.float32(0.0))
        pe = torch.arange(0, 3_000, 7, dtype=torch.int32)
        m = faults.wear_mult(p, pe, 1_000.0).numpy()
        # bit-exact 1.0: `rate * wear_mult` must equal the flat rate
        assert (m == np.float32(1.0)).all()

    def test_zero_slope_draws_ignore_rated_limit(self):
        # with the curve off, neither pe/rated scaling nor the rated limit
        # may leak into the draw comparison (pe still seeds the counter
        # hash, as it always has)
        ids = torch.arange(32_768, dtype=torch.int32)
        pe = (ids * 13 % 900).to(torch.int32)
        p = _params(read_fail_rate=np.float32(0.05))
        a = faults.read_fails(p, ids, pe, 1_000.0).numpy()
        b = faults.read_fails(p, ids, pe, 3_000.0).numpy()
        np.testing.assert_array_equal(a, b)

    def test_multiplier_monotone_in_pe(self):
        p = _params(wear_slope=np.float32(8.0))
        pe = i32(np.linspace(0, 1_000, 21).astype(np.int32))
        m = faults.wear_mult(p, pe, 1_000.0).numpy().astype(np.float64)
        assert (np.diff(m) >= 0).all() and m[-1] > m[0]
        assert m[0] == 1.0 and m[-1] == pytest.approx(9.0)

    def test_fire_rate_monotone_and_matches_curve(self):
        """Empirical firing fraction tracks rate * (1 + slope*(pe/rated)^4)
        across drive life, for the per-page and per-block draw classes."""
        n = 100_000
        ids = torch.arange(n, dtype=torch.int32)
        p = _params(prog_fail_rate=np.float32(0.02),
                    read_fail_rate=np.float32(0.02),
                    wear_slope=np.float32(8.0))
        for draw in (faults.prog_fails, faults.read_fails):
            frac = []
            for pe in (0, 250, 500, 750, 950):
                fires = draw(p, ids, torch.full((n,), pe, dtype=torch.int32),
                             1_000.0).numpy()
                frac.append(fires.mean())
                want = 0.02 * (1.0 + 8.0 * (pe / 1_000.0) ** 4)
                assert frac[-1] == pytest.approx(want, rel=0.15, abs=0.002)
            assert (np.diff(frac) > 0).all()

    def test_saturated_rate_always_fires(self):
        ids = torch.arange(4_096, dtype=torch.int32)
        p = _params(erase_fail_rate=np.float32(0.2),
                    wear_slope=np.float32(50.0))
        fires = faults.erase_fails(
            p, ids, torch.full((4_096,), 990, dtype=torch.int32), 1_000.0).numpy()
        assert fires.all()  # 0.2 * (1 + 50*0.96) >> 1

    def test_knob_fields_fall_back_to_config(self):
        cfg = geometry.tiny_config(read_fail_rate=0.125, fault_wear_slope=3.0,
                                   parity_rebuild=True, spare_blocks=9)
        # knob-armed run (prog_fail_rate set selects the knob path) whose
        # new fields are unset: they must resolve from the static config
        k = policies.RunKnobs(r1=1, r2_override=-1, initial_pe=500,
                              prog_fail_rate=np.float32(0.0),
                              erase_fail_rate=np.float32(0.0),
                              max_read_retries=np.int32(-1),
                              fault_seed=np.int32(1))
        p = faults.params_for(cfg, k, device=CPU)
        assert float(p.read_fail_rate) == pytest.approx(0.125)
        assert float(p.wear_slope) == pytest.approx(3.0)
        assert int(p.parity_rebuild) == 1
        # and explicit knob values win over the statics
        k2 = k._replace(read_fail_rate=np.float32(0.5),
                        fault_wear_slope=np.float32(7.0),
                        parity_rebuild=np.int32(0))
        p2 = faults.params_for(cfg, k2, device=CPU)
        assert float(p2.read_fail_rate) == pytest.approx(0.5)
        assert float(p2.wear_slope) == pytest.approx(7.0)
        assert int(p2.parity_rebuild) == 0

    def test_engine_uncorrectables_rise_with_drive_age(self):
        """Acceptance criterion: same trace, same rates — an old device
        (P/E 833 of 1000) must see more uncorrectable reads than a young
        one (P/E 166) once the wear curve is armed."""
        mk = lambda pe: geometry.tiny_config(  # noqa: E731
            policy=geometry.BASELINE, initial_pe=pe,
            read_fail_rate=0.01, fault_wear_slope=8.0, fault_seed=1)
        # near-uniform reads: the draw is deterministic per (slot, pe), so a
        # skewed trace would re-sample a handful of slots' luck instead of
        # the population rate
        tr = workload.zipf_read_trace(mk(100), 8_192, 0.3, seed=1)
        s_young, _ = run(mk(100), tr)
        s_old, _ = run(mk(950), tr)
        assert float(s_young.n_uncorrectable) > 0
        assert float(s_old.n_uncorrectable) > 2.0 * float(s_young.n_uncorrectable)


# --------------------- traced-neutral-knob bit identity --------------------


class TestNeutralKnobBitIdentity:
    def test_neutral_arrays_match_config_fallback(self):
        """Knob fields passed as explicit neutral values (rate 0, slope 0,
        parity off, unbounded spares) must reproduce the runs where they are
        ``None`` and resolve from the static config — bit for bit across
        every state leaf."""
        R = 2
        cfg = geometry.tiny_config(policy=geometry.RARO)
        tr = _mixed(cfg, n=2_048, read_frac=0.5, write_theta=2.0)
        base = dict(
            r1=np.full(R, cfg.r1, np.int32),
            r2_override=np.full(R, -1, np.int32),
            initial_pe=np.full(R, 833, np.int32),
            prog_fail_rate=np.full(R, 0.05, np.float32),
            erase_fail_rate=np.full(R, 0.05, np.float32),
            max_read_retries=np.full(R, 6, np.int32),
            fault_seed=np.arange(1, R + 1, dtype=np.int32),
        )
        k_none = dict(base)
        k_neutral = dict(
            **base,
            read_fail_rate=np.zeros(R, np.float32),
            fault_wear_slope=np.zeros(R, np.float32),
            parity_rebuild=np.zeros(R, np.int32),
            spare_blocks=np.full(R, -1, np.int32),
        )
        # the reference's sweep._sweep_jit over both knob sets, run by run
        for sa, sb in zip(knob_runs(cfg, tr, k_none), knob_runs(cfg, tr, k_neutral)):
            for name, a, b in zip(sa._fields, sa, sb):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b),
                    err_msg=f"state leaf {name!r} diverged under explicit "
                            f"neutral wear/parity/spare knobs")


# ----------------------------- parity rebuild ------------------------------


class TestParityRebuild:
    @pytest.fixture(scope="class")
    def runs(self):
        mk = lambda **kw: geometry.tiny_config(  # noqa: E731
            policy=geometry.BASELINE, initial_pe=900, obs_level="full",
            max_read_retries=2, read_fail_rate=0.01, fault_seed=1, **kw)
        cfg = mk(parity_rebuild=True)
        tr = workload.zipf_read_trace(cfg, 8_192, 1.2, seed=1)
        s, _ = run(cfg, tr)
        # parity off *and* free ECC recovery: identical draws, identical
        # retries — the only delta left is the rebuild work itself
        cfg0 = mk(read_recovery_us=0.0)
        s0, _ = run(cfg0, tr)
        return cfg, s, cfg0, s0, tr

    def test_rebuild_run_equals_reference(self, runs):
        cfg, s, _, _, tr = runs
        check_against_reference(cfg, tr, s)

    def test_rebuilds_fire_and_are_bounded(self, runs):
        cfg, s, _, s0, _ = runs
        assert float(s.n_uncorrectable) > 0
        assert float(s.n_rebuilds) == float(s.n_uncorrectable)
        assert 0.0 <= float(s.n_data_loss) <= float(s.n_rebuilds)
        # parity off: same uncorrectables, no rebuilds, no loss
        assert float(s0.n_uncorrectable) == float(s.n_uncorrectable)
        assert float(s0.n_rebuilds) == 0.0
        assert float(s0.n_data_loss) == 0.0

    def test_rebuild_latency_attributed_and_mass_conserved(self, runs):
        cfg, s, _, s0, _ = runs
        comp = np.asarray(s.obs_lat_comp, np.float64)
        assert comp[:, obs.COMP_REBUILD].sum() > 0.0
        assert np.asarray(s0.obs_lat_comp)[:, obs.COMP_REBUILD].sum() == 0.0
        # attribution never loses a read: per-mode counts still cover the
        # total histogram bit-exactly with the rebuild lane split out
        assert np.array_equal(np.asarray(s.obs_lat_mode).sum(axis=0),
                              np.asarray(s.lat_hist))

    def test_rebuild_charges_the_lattice(self, runs):
        """Rebuild reads n_dies-1 stripe peers and ships their pages over
        the channels: against the free-recovery baseline (same draws, same
        retries) the reconstruction must show up as extra die busy time,
        extra channel busy time, and longer read service."""
        cfg, s, cfg0, s0, _ = runs
        assert float(np.asarray(s.die_busy_ms).sum()) > \
            float(np.asarray(s0.die_busy_ms).sum())
        assert float(np.asarray(s.chan_busy_ms).sum()) > \
            float(np.asarray(s0.chan_busy_ms).sum())
        assert float(s.svc_sum_ms) > float(s0.svc_sum_ms)

    def test_summary_exposes_rebuild_counters(self, runs):
        cfg, s, _, _, _ = runs
        m = engine.summarize(s, cfg)
        assert m["rebuilds"] == float(s.n_rebuilds) > 0
        assert m["data_loss"] == float(s.n_data_loss)

    def test_single_die_device_never_rebuilds(self):
        cfg = geometry.tiny_config(
            policy=geometry.BASELINE, initial_pe=900, n_channels=1,
            luns_per_channel=1, n_logical=768,  # 16 blocks on the one die
            max_read_retries=2, read_fail_rate=0.01,
            parity_rebuild=True, fault_seed=1)
        tr = workload.zipf_read_trace(cfg, 4_096, 1.2, seed=1)
        s, _ = run(cfg, tr)
        # no stripe peers -> reconstruction impossible: flat ECC penalty
        # only, and no data-loss accounting either
        assert float(s.n_uncorrectable) > 0
        assert float(s.n_rebuilds) == 0.0
        assert float(s.n_data_loss) == 0.0


# ------------------------------- spare pool --------------------------------


_pressure_cfg = pressure_cfg


class TestSparePool:
    @pytest.fixture(scope="class")
    def drained(self):
        cfg = _pressure_cfg(spare_blocks=2)
        tr = _mixed(cfg, n=16_384, read_frac=0.1, write_theta=2.0)
        s, _ = run(cfg, tr)
        return cfg, s

    def test_retirements_consume_spares_until_dry(self, drained):
        cfg, s = drained
        assert float(s.n_erase_fails) > 2  # enough failures to drain 2 spares
        assert int(s.spare_total) == 2
        assert int(s.spare_count) == 0
        st.check_invariants(s, cfg)

    def test_exhaustion_flips_read_only_without_corruption(self, drained):
        cfg, s = drained
        # writes after exhaustion are dropped-and-counted, never mapped
        assert float(s.n_degraded_writes) > 0
        m = engine.summarize(s, cfg)
        assert m["degraded"] == 1.0
        assert m["degraded_writes"] == float(s.n_degraded_writes)
        assert m["spares_remaining"] == 0.0 and m["spares_total"] == 2.0
        # reads still serve every mapped page: bijection intact
        l2p = np.asarray(s.l2p)
        assert (l2p >= 0).all()

    def test_unbounded_pool_never_degrades(self):
        cfg = _pressure_cfg()  # spare_blocks defaults to -1
        tr = _mixed(cfg, n=16_384, read_frac=0.1, write_theta=2.0)
        s, _ = run(cfg, tr)
        assert int(s.spare_total) == st.SPARE_UNLIMITED
        assert float(s.n_degraded_writes) == 0.0
        m = engine.summarize(s, cfg)
        # sentinel pool reports as unbounded, not as a huge number
        assert m["spares_total"] == -1.0 and m["spares_remaining"] == -1.0
        assert m["degraded"] == 0.0

    def test_capacity_summary_reflects_spare_coverage(self, drained):
        cfg, s = drained
        m = engine.summarize(s, cfg)
        # retirements beyond the pool size are real capacity loss; the
        # covered part is credited back into effective capacity
        assert m["spare_covered_gib"] >= 0.0
        assert m["effective_capacity_gib"] == pytest.approx(
            m["capacity_gib"] + m["spare_covered_gib"])
        assert m["bad_blocks"] == float(s.bad_count) > 2

    R = 3  # runs of each example, as the reference's batch width

    @settings(max_examples=8, deadline=None)
    @given(
        spares=st_h.lists(st_h.integers(0, 5), min_size=R, max_size=R),
        slope=st_h.lists(st_h.floats(0.0, 16.0), min_size=R, max_size=R),
        seed=st_h.integers(0, 2**16),
    )
    def test_exhaustion_never_corrupts_mapping(self, spares, slope, seed):
        """Property: any spare-pool size crossed with any wear slope keeps
        every per-run state consistent — mapping bijection, exact free
        counts, spare accounting, and degraded writes only after the pool
        actually ran dry."""
        cfg = geometry.tiny_config(policy=geometry.RARO, n_logical=2_944,
                                   gc_free_threshold=18, gc_victims_per_pass=4)
        tr = _mixed(cfg, n=2_048, read_frac=0.3, write_theta=2.0)
        knobs = dict(
            r1=np.full(self.R, cfg.r1, np.int32),
            r2_override=np.full(self.R, -1, np.int32),
            initial_pe=np.full(self.R, 900, np.int32),
            prog_fail_rate=np.full(self.R, 0.02, np.float32),
            erase_fail_rate=np.full(self.R, 0.2, np.float32),
            max_read_retries=np.full(self.R, 4, np.int32),
            fault_seed=np.asarray([seed + i for i in range(self.R)], np.int32),
            read_fail_rate=np.full(self.R, 0.01, np.float32),
            fault_wear_slope=np.asarray(slope, np.float32),
            parity_rebuild=np.ones(self.R, np.int32),
            spare_blocks=np.asarray(spares, np.int32),
        )
        # the reference's sweep._sweep_jit + sweep._take_run, run by run
        for i, s in enumerate(knob_runs(cfg, tr, knobs)):
            st.check_invariants(s, cfg)
            assert int(s.spare_total) == spares[i]
            if float(s.n_degraded_writes) > 0:
                assert int(s.spare_count) == 0
            assert float(s.n_data_loss) <= float(s.n_rebuilds)
            assert float(s.n_rebuilds) <= float(s.n_uncorrectable)


# -------------------------- youngest-first alloc ---------------------------


class TestYoungestAlloc:
    def _aged_state(self, cfg):
        s = st.init_state(cfg, device=CPU)
        free = np.asarray(s.block_state) == st.FREE
        assert free.sum() >= 4
        # age blocks in reverse id order: the lowest-id free block is the
        # most worn, so the two policies must disagree
        pe = (cfg.n_blocks - np.arange(cfg.n_blocks)).astype(np.int32) * 10
        return s._replace(block_pe=i32(pe)), free

    def test_default_policy_is_lowest_id(self):
        cfg = TINY
        s, free = self._aged_state(cfg)
        got = int(ftl.alloc_free_block(s, cfg=cfg))
        assert got == int(np.flatnonzero(free)[0])

    def test_youngest_picks_minimum_wear(self):
        cfg = geometry.tiny_config(alloc_policy="youngest")
        s, free = self._aged_state(cfg)
        got = int(ftl.alloc_free_block(s, cfg=cfg))
        ids = np.flatnonzero(free)
        pe = np.asarray(s.block_pe)
        assert got == ids[np.argmin(pe[ids])]
        assert got != int(ids[0])  # genuinely diverges from lowest-id

    def test_youngest_respects_die_affinity(self):
        cfg = geometry.tiny_config(alloc_policy="youngest")
        s, free = self._aged_state(cfg)
        lun = 1
        got = int(ftl.alloc_free_block(s, prefer_lun=lun, cfg=cfg))
        ids = np.flatnonzero(free)
        on_die = ids[ids % cfg.n_dies == lun]
        pe = np.asarray(s.block_pe)
        assert got == on_die[np.argmin(pe[on_die])]

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="alloc_policy"):
            geometry.tiny_config(alloc_policy="oldest")

    def test_youngest_run_levels_wear(self):
        """End to end: under write pressure the wear-levelled allocator
        keeps the P/E spread no worse than lowest-id, with a coherent
        state throughout."""
        mk = lambda pol: geometry.tiny_config(  # noqa: E731
            policy=geometry.BASELINE, n_logical=2_944, gc_free_threshold=18,
            gc_victims_per_pass=4, alloc_policy=pol)
        tr = _mixed(mk("youngest"), n=16_384, read_frac=0.1, write_theta=2.0)
        s_y, _ = run(mk("youngest"), tr)
        s_l, _ = run(mk("lowest_id"), tr)
        st.check_invariants(s_y, mk("youngest"))
        assert float(s_y.n_writes) > 0
        my = engine.summarize(s_y, mk("youngest"))
        ml = engine.summarize(s_l, mk("lowest_id"))
        assert my["pe_variance"] <= ml["pe_variance"] * 1.5 + 1.0


# ------------------------- windowed WAF time series ------------------------


class TestWafWindow:
    @pytest.fixture(scope="class")
    def ts_run(self):
        cfg = geometry.tiny_config(
            policy=geometry.RARO, initial_pe=500, obs_level="full",
            obs_windows=32, obs_window_ms=5.0, n_logical=2_944,
            gc_free_threshold=18, gc_victims_per_pass=4)
        tr = _mixed(cfg, n=16 * cfg.chunk, read_frac=0.3, write_theta=2.0)
        s, _ = run(cfg, tr)
        return cfg, s

    def test_reloc_series_recorded(self, ts_run):
        cfg, s = ts_run
        ts = obs.decode_timeseries(s, cfg)
        assert "reloc_pages" in ts and "waf_window" in ts
        # windowed relocations never exceed the run total (windows past the
        # ring capacity are dropped, not wrapped)
        assert 0.0 <= ts["reloc_pages"].sum() <= float(s.n_reloc_pages)

    def test_waf_window_bounded_below_by_one(self, ts_run):
        cfg, s = ts_run
        ts = obs.decode_timeseries(s, cfg)
        assert np.isfinite(ts["waf_window"]).all()
        assert (ts["waf_window"] >= 1.0).all()
        # pressure windows actually amplified: some window exceeds 1.0
        assert (ts["waf_window"] > 1.0).any()

    def test_chunk_metrics_split_user_and_reloc_pages(self, ts_run):
        cfg, s = ts_run
        tr = _mixed(cfg, n=16 * cfg.chunk, read_frac=0.3, write_theta=2.0)
        _, m = run(cfg, tr)
        user = np.asarray(m.user_pages, np.float64)
        reloc = np.asarray(m.reloc_pages, np.float64)
        assert user.sum() == float(s.n_writes)
        assert reloc.sum() == float(s.n_reloc_pages)
        assert (user >= 0).all() and (reloc >= 0).all()
