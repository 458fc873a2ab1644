"""Twin of tests/test_ssdsim.py: the port's flash-simulator layer
(``repro_torch.ssdsim``: ``state``, ``engine``, ``ftl``) held by the
reference's integration and property tests on the CPU, with the same
seeds, sizes and hypothesis settings; and the RARO run of ``TestEngine``
held against the JAX package's engine by tests/torch_ssd_compare.py's
rule."""

import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_twins import CPU, check_against_reference, i32, one_torch_thread, run  # noqa: F401

from repro_torch.core import modes
from repro_torch.ssdsim import engine, ftl, geometry, state as st, workload

TINY = geometry.tiny_config()


def _invariants(s, cfg):
    """Full-state consistency — delegated to the shared
    ``state.check_invariants`` helper (mapping bijection, valid counts,
    free-pool bookkeeping, cursor sanity)."""
    st.check_invariants(s, cfg)


def _kill(s, blocks, spb, keep=16):
    """Invalidate all but the last ``keep`` slots of each block in
    ``blocks`` (the reference's ``p2l.at[kill].set(-1)`` edits)."""
    kill = torch.cat([torch.arange(b * spb, (b + 1) * spb - keep) for b in blocks])
    p2l, l2p, bv = s.p2l.clone(), s.l2p.clone(), s.block_valid.clone()
    p2l[kill] = -1
    l2p[kill] = -1
    bv[list(blocks)] -= spb - keep
    return s._replace(p2l=p2l, l2p=l2p, block_valid=bv)


class TestInit:
    def test_initial_capacity_is_full_qlc(self):
        s = st.init_state(TINY, device=CPU)
        cap = int(st.usable_capacity_pages(s, TINY))
        assert cap == TINY.n_blocks * TINY.slots_per_block

    def test_initial_mapping(self):
        s = st.init_state(TINY, device=CPU)
        _invariants(s, TINY)
        assert (s.l2p.numpy() >= 0).all()


class TestEngine:
    @pytest.fixture(scope="class")
    def raro_run(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=500)
        tr = workload.zipf_read_trace(cfg, 20_000, 1.2, seed=1)
        s, ys = run(cfg, tr)
        return cfg, s, ys, tr

    def test_invariants_after_run(self, raro_run):
        cfg, s, _, _ = raro_run
        _invariants(s, cfg)

    def test_no_data_loss(self, raro_run):
        cfg, s, _, _ = raro_run
        assert (s.l2p.numpy() >= 0).all()  # every logical page still mapped

    def test_conversions_happened(self, raro_run):
        cfg, s, _, _ = raro_run
        conv = s.n_conversions.numpy()
        assert conv[modes.QLC, modes.SLC] + conv[modes.QLC, modes.TLC] > 0

    def test_capacity_loss_matches_mode_deficit(self, raro_run):
        cfg, s, _, _ = raro_run
        ppb = geometry.pages_per_block_host(cfg)
        bm, bs = s.block_mode.numpy(), s.block_state.numpy()
        nonfree = bs != st.FREE
        deficit = (ppb[modes.QLC] - ppb[bm[nonfree]]).sum()
        cap = int(st.usable_capacity_pages(s, cfg))
        assert cap == cfg.n_blocks * cfg.slots_per_block - deficit

    def test_run_equals_reference(self, raro_run):
        cfg, s, _, tr = raro_run
        check_against_reference(cfg, tr, s)

    def test_baseline_never_converts(self):
        cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=500)
        tr = workload.zipf_read_trace(cfg, 5_000, 1.2, seed=1)
        s, _ = run(cfg, tr)
        assert float(s.n_conversions.sum()) == 0.0
        assert float(s.n_migrated_pages) == 0.0

    def test_raro_beats_baseline_iops(self):
        res = {}
        for pol in (geometry.BASELINE, geometry.RARO):
            cfg = geometry.tiny_config(policy=pol, initial_pe=833)
            tr = workload.zipf_read_trace(cfg, 20_000, 1.2, seed=1)
            s, _ = run(cfg, tr)
            res[pol] = engine.summarize(s, cfg)["iops"]
        assert res[geometry.RARO] > 3.0 * res[geometry.BASELINE]

    def test_raro_saves_capacity_vs_hotness(self):
        res = {}
        for pol in (geometry.HOTNESS, geometry.RARO):
            cfg = geometry.tiny_config(policy=pol, initial_pe=166)
            tr = workload.zipf_read_trace(cfg, 20_000, 1.2, seed=1)
            s, _ = run(cfg, tr)
            res[pol] = engine.summarize(s, cfg)
        assert (
            res[geometry.RARO]["capacity_loss_gib"]
            <= res[geometry.HOTNESS]["capacity_loss_gib"]
        )
        assert (
            res[geometry.RARO]["migrated_pages"]
            < res[geometry.HOTNESS]["migrated_pages"]
        )

    def test_retry_counts_grow_with_wear(self):
        out = {}
        for pe in (166, 833):
            cfg = geometry.tiny_config(policy=geometry.BASELINE, initial_pe=pe)
            tr = workload.zipf_read_trace(cfg, 5_000, 1.2, seed=1)
            s, _ = run(cfg, tr)
            out[pe] = engine.summarize(s, cfg)["retries_per_read"]
        assert out[833] > out[166]

    def test_write_path(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=166)
        tr = workload.mixed_trace(cfg, 3_000, 1.2, read_frac=0.6, seed=2)
        s, _ = run(cfg, tr)
        _invariants(s, cfg)
        assert float(s.n_writes) > 0
        assert (s.l2p.numpy() >= 0).all()

    def test_write_latency_histogram(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=166)
        tr = workload.mixed_trace(cfg, 3_000, 1.2, read_frac=0.6, seed=2)
        s, ys = run(cfg, tr)
        # every successful write lands in exactly one histogram bin, and the
        # per-chunk histograms stack to the cumulative one
        assert float(s.w_lat_hist.sum()) == float(s.n_writes)
        np.testing.assert_allclose(
            ys.w_lat_hist.numpy().sum(0), s.w_lat_hist.numpy(), rtol=1e-6
        )
        m = engine.summarize(s, cfg)
        assert m["write_lat_p50_us"] > 0
        assert m["write_lat_p99_us"] >= m["write_lat_p50_us"]

    def test_read_only_run_records_no_writes(self):
        cfg = geometry.tiny_config(policy=geometry.RARO, initial_pe=166)
        tr = workload.zipf_read_trace(cfg, 2_000, 1.2, seed=3)
        s, _ = run(cfg, tr)
        assert float(s.w_lat_hist.sum()) == 0.0
        assert engine.summarize(s, cfg)["write_lat_p50_us"] == 0.0

    def test_single_thread_summary(self, raro_run):
        cfg, s, _, _ = raro_run
        m1 = engine.summarize(s, cfg, threads=1)
        m4 = engine.summarize(s, cfg, threads=4)
        assert m1["iops"] > 0 and m4["iops"] > 0


class TestFTL:
    def test_migrate_block_roundtrip(self):
        cfg = TINY
        s = st.init_state(cfg, device=CPU)
        cap0 = int(st.usable_capacity_pages(s, cfg))
        s2 = ftl.migrate_block(s, i32(0), i32(modes.SLC), cfg)
        _invariants(s2, cfg)
        # all pages from block 0 still mapped somewhere else
        assert (s2.l2p.numpy()[: cfg.slots_per_block] >= 0).all()
        assert (s2.l2p.numpy()[: cfg.slots_per_block] >= cfg.slots_per_block).all()
        # capacity shrank by the SLC deficit of the opened blocks
        cap1 = int(st.usable_capacity_pages(s2, cfg))
        assert cap1 < cap0
        assert float(s2.n_erases) == 1.0

    def test_migrate_pages_moves_and_invalidates(self):
        cfg = TINY
        s = st.init_state(cfg, device=CPU)
        lpns = i32([0, 1, 2, -1, -1, -1, 7, 9] + [-1] * 8)
        s2 = ftl.migrate_pages(s, lpns, modes.SLC, cfg)
        _invariants(s2, cfg)
        moved = s2.l2p.numpy()[[0, 1, 2, 7, 9]]
        assert (moved != np.array([0, 1, 2, 7, 9])).all()
        bm = s2.block_mode.numpy()
        assert (bm[moved // cfg.slots_per_block] == modes.SLC).all()

    def test_gc_reclaims_space(self):
        cfg = geometry.tiny_config(gc_free_threshold=100)  # force GC pressure
        s = st.init_state(cfg, device=CPU)
        # make blocks 0 and 1 mostly-invalid GC victims (16/64 valid each)
        s = _kill(s, (0, 1), cfg.slots_per_block)
        free0 = int(ftl.free_block_count(s))
        # two passes: both victims compact into ONE shared open block, so the
        # pool nets at least one extra free block.
        s2 = ftl.gc_step(ftl.gc_step(s, cfg), cfg)
        _invariants(s2, cfg)
        assert int(ftl.free_block_count(s2)) >= free0 + 1
        assert float(s2.n_erases) == 2.0

    def test_gc_never_fires_above_free_threshold(self):
        """Regression: with a healthy free pool GC must be an explicit no-op
        even when mostly-invalid victim blocks exist."""
        cfg = geometry.tiny_config(gc_free_threshold=2)  # pool starts at 40
        s = st.init_state(cfg, device=CPU)
        s = _kill(s, (0,), cfg.slots_per_block)  # block 0 mostly invalid
        assert int(ftl.free_block_count(s)) >= cfg.gc_free_threshold
        s2 = ftl.gc_step(s, cfg)
        assert float(s2.n_erases) == 0.0
        for name, a, b in zip(s._fields, s, s2):
            assert (np.asarray(a) == np.asarray(b)).all(), name

    def test_fused_reclaim_matches_block_migration_counters(self):
        """The fused demotion pass migrates + erases each victim exactly once
        and keeps the state invariants."""
        cfg = geometry.tiny_config()
        s = st.init_state(cfg, device=CPU)
        # convert blocks 0 and 1 to TLC-full demotion candidates
        s = ftl.migrate_block(s, i32(0), i32(modes.TLC), cfg)
        s = ftl.migrate_block(s, i32(1), i32(modes.TLC), cfg)
        tlc_full = (s.block_mode.numpy() == modes.TLC) & (s.block_state.numpy() == st.FULL)
        assert tlc_full.any()
        victims = i32(np.nonzero(tlc_full)[0][:2])
        K = victims.shape[0]
        conv0 = float(s.n_conversions[modes.TLC, modes.QLC])
        erases0 = float(s.n_erases)
        s2 = ftl.reclaim_victims(
            s,
            victims,
            torch.ones((K,), dtype=torch.bool),
            torch.full((K,), modes.QLC, dtype=torch.int32),
            cfg,
        )
        _invariants(s2, cfg)
        assert float(s2.n_conversions[modes.TLC, modes.QLC]) == conv0 + K
        assert float(s2.n_erases) == erases0 + K
        assert (s2.block_state.numpy()[victims.numpy()] == st.FREE).all()


@settings(max_examples=10, deadline=None)
@given(
    seed=st_h.integers(0, 2**16),
    theta=st_h.floats(0.6, 1.5),
    pol=st_h.sampled_from([geometry.BASELINE, geometry.HOTNESS, geometry.RARO]),
    pe=st_h.integers(0, 1000),
)
def test_property_engine_invariants(seed, theta, pol, pe):
    """Any (workload, policy, wear) keeps the FTL state consistent."""
    cfg = geometry.tiny_config(policy=pol, initial_pe=pe)
    tr = workload.zipf_read_trace(cfg, 2_000, theta, seed=seed)
    s, ys = run(cfg, tr)
    _invariants(s, cfg)
    cap = ys.capacity_pages.numpy()
    assert (cap > 0).all()
    assert (ys.free_blocks.numpy() >= 0).all()
