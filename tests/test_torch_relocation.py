"""The port's fused relocation kernel (``ftl.relocate_group`` +
``ftl._erase_many``) against its sequential oracles, the twin of
``tests/test_relocation.py``:

- fused GC with ``gc_victims_per_pass=1`` equals ``gc_pass_reference`` on
  all integer and mapping state (float busy-time accumulators allclose,
  rtol 1e-6 and atol 1e-6, the reference's own standard);
- ``_erase_many`` equals K sequential ``_erase`` calls;
- with k > 1 the fused victim set equals k sequential greedy argmin picks,
  and every relocation pass keeps ``state.check_invariants`` clean,
  preserves the mapped-page set, and conserves capacity when modes are
  unchanged.

``TestOraclesMatchReference`` holds each of the port's oracles
(``_erase``, ``_migrate_block_reference``, ``gc_pass_reference``,
``gc_step_reference``) against the JAX package's from the same state, by
``tests/torch_ssd_compare.py``'s rule (integers exact, floats rtol 1e-5,
histograms within one bin).
"""

import numpy as np
import pytest
import torch
from torch_ssd_compare import compare_leaves

from repro_torch.core import modes
from repro_torch.ssdsim import engine, ftl, geometry, state as st, workload

# the reference's deterministic seed sweep (the bit-identity proof runs in
# tier-1 with or without hypothesis)
SEEDS = [0, 1, 7, 11, 101, 1234, 9999, 2**15]
CPU = "cpu"


def assert_states_match(a: st.SSDState, b: st.SSDState, tag=""):
    """Bitwise on integer/mapping state; allclose on float accumulators."""
    for name, x, y in zip(a._fields, a, b):
        x, y = x.numpy(), y.numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(
                x, y, rtol=1e-6, atol=1e-6, err_msg=f"{tag}: float field {name}"
            )
        else:
            bad = np.nonzero(np.atleast_1d(x != y))[0]
            assert (x == y).all(), (
                f"{tag}: field {name} differs at {bad[:8]}: "
                f"a={np.atleast_1d(x)[bad][:8]} b={np.atleast_1d(y)[bad][:8]}"
            )


def _kill_pages(s: st.SSDState, cfg, rng, n_victim_blocks):
    """Unmap a random number of pages in ``n_victim_blocks`` random FULL
    blocks, making them GC victims with distinct-ish valid counts."""
    spb = cfg.slots_per_block
    l2p = s.l2p.numpy().copy()
    p2l = s.p2l.numpy().copy()
    bv = s.block_valid.numpy().copy()
    full = np.nonzero(s.block_state.numpy() == st.FULL)[0]
    picks = rng.choice(full, size=min(n_victim_blocks, len(full)), replace=False)
    for b in picks:
        slots = np.nonzero(p2l[b * spb:(b + 1) * spb] >= 0)[0] + b * spb
        if len(slots) < 2:
            continue
        nk = int(rng.integers(1, len(slots)))
        ks = rng.choice(slots, size=nk, replace=False)
        l2p[p2l[ks]] = -1
        p2l[ks] = -1
        bv[b] -= nk
    return s._replace(
        l2p=torch.from_numpy(l2p), p2l=torch.from_numpy(p2l), block_valid=torch.from_numpy(bv)
    )


def _pressure_state(cfg, seed, n_victim_blocks=6, demote=0):
    """``init_state`` + random page kills (and optionally a few blocks
    converted to SLC/TLC first, for mode diversity among victims)."""
    rng = np.random.default_rng(seed)
    s = st.init_state(cfg, device=CPU)
    for i in range(demote):
        tgt = modes.TLC if i % 2 else modes.SLC
        s = ftl.migrate_block(s, 2 + i, tgt, cfg)
    return _kill_pages(s, cfg, rng, n_victim_blocks)


class TestFusedGCBitIdentity:
    """gc_victims_per_pass=1 must reproduce the scalar oracle exactly."""

    @pytest.mark.parametrize("seed", SEEDS)
    def test_property_k1_matches_reference(self, seed):
        cfg = geometry.tiny_config(gc_free_threshold=50, gc_victims_per_pass=1)
        s = _pressure_state(cfg, seed, n_victim_blocks=5, demote=seed % 3)
        a, b = s, s
        for step in range(3):  # chained passes: each starts from fused state
            a = ftl.gc_step(a, cfg)
            b = ftl.gc_step_reference(b, cfg)
            assert_states_match(a, b, tag=f"pass {step}")
        st.check_invariants(a, cfg, "fused k=1")

    def test_k1_matches_reference_after_engine_run(self):
        """States reached by a real write-heavy engine run under free-pool
        pressure agree between the fused and the oracle GC passes."""
        cfg = geometry.tiny_config(
            n_logical=3200, gc_free_threshold=14, gc_victims_per_pass=1,
            policy=geometry.RARO, initial_pe=500,
        )
        tr = workload.mixed_trace(cfg, 6 * cfg.chunk, 1.2, read_frac=0.3, seed=3)
        s, _ = engine.run(cfg, tr, device=CPU)
        assert float(s.n_erases) > 0  # the run actually exercised GC
        a = ftl.gc_step(s, cfg)
        b = ftl.gc_step_reference(s, cfg)
        assert_states_match(a, b, tag="post-run")
        st.check_invariants(a, cfg, "post-run fused")

    def test_no_op_above_watermark_is_exact(self):
        cfg = geometry.tiny_config(gc_free_threshold=2, gc_victims_per_pass=1)
        s = _pressure_state(cfg, 7, n_victim_blocks=3)
        a = ftl.gc_step(s, cfg)
        for name, x, y in zip(s._fields, s, a):
            assert torch.equal(x, y), name


class TestEraseMany:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_property_matches_sequential_erase(self, seed):
        """One vectorized ``_erase_many`` == K sequential ``_erase`` calls.
        Victims are sorted ascending so the sequential loop's
        last-erase-per-die hint equals the fused segment-max hint; ints
        bitwise, float busy time allclose (summation order)."""
        cfg = geometry.tiny_config()
        rng = np.random.default_rng(seed)
        s = st.init_state(cfg, device=CPU)
        full = np.nonzero(s.block_state.numpy() == st.FULL)[0]
        k = int(rng.integers(1, 6))
        victims = np.sort(rng.choice(full, size=min(k, len(full)), replace=False))
        grp = rng.random(len(victims)) < 0.8
        a = ftl._erase_many(
            s, torch.from_numpy(victims.astype(np.int32)), torch.from_numpy(grp), cfg
        )
        b = s
        for v, g in zip(victims, grp):
            if g:
                b = ftl._erase(b, int(v), cfg)
        assert_states_match(a, b, tag=f"victims={victims[grp]}")
        assert int(a.free_count) == int(s.free_count) + int(grp.sum())

    def test_masked_out_lanes_untouched(self):
        cfg = geometry.tiny_config()
        s = st.init_state(cfg, device=CPU)
        a = ftl._erase_many(
            s, torch.tensor([0, 1], dtype=torch.int32), torch.zeros((2,), dtype=torch.bool), cfg
        )
        for name, x, y in zip(s._fields, s, a):
            assert torch.equal(x, y), name


class TestMultiVictimGC:
    def test_victim_set_equals_sequential_greedy(self):
        """The fused top-k victim set equals k sequential greedy min-valid
        picks (selection replayed against the evolving oracle state)."""
        k = 4
        cfg = geometry.tiny_config(gc_free_threshold=100, gc_victims_per_pass=k)
        s = _pressure_state(cfg, 11, n_victim_blocks=8)
        victims, ok = ftl.select_gc_victims(s, cfg, k)
        fused_picks = list(victims.numpy()[ok.numpy()])
        assert len(fused_picks) == k

        ppb = geometry.pages_per_block_host(cfg)
        ref = s
        greedy = []
        for _ in range(k):
            bs = ref.block_state.numpy()
            bv = ref.block_valid.numpy()
            bm = ref.block_mode.numpy()
            score = np.where(
                (bs == st.FULL) & (bv < ppb[bm]), bv, np.iinfo(np.int32).max
            )
            pick = int(np.argmin(score))
            assert score[pick] < np.iinfo(np.int32).max
            greedy.append(pick)
            ref = ftl.gc_pass_reference(ref, cfg)
        assert fused_picks == greedy

    @pytest.mark.parametrize("seed,k", [(s, 2 + s % 3) for s in SEEDS])
    def test_property_invariants_after_fused_pass(self, seed, k):
        """Any fused multi-victim pass keeps the full invariant suite clean
        and never unmaps a logical page."""
        cfg = geometry.tiny_config(gc_free_threshold=100, gc_victims_per_pass=k)
        s = _pressure_state(cfg, seed, n_victim_blocks=2 * k, demote=seed % 4)
        mapped0 = s.l2p.numpy() >= 0
        free0 = int(s.free_count)
        s2 = ftl.gc_step(s, cfg)
        st.check_invariants(s2, cfg, f"k={k}")
        np.testing.assert_array_equal(s2.l2p.numpy() >= 0, mapped0)
        assert int(s2.free_count) >= free0  # GC never shrinks the pool

    def test_qlc_only_pass_conserves_capacity(self):
        """Same-mode (QLC) relocation conserves usable capacity exactly:
        victims return to the free pool at QLC density and destinations are
        opened at QLC density."""
        k = 3
        cfg = geometry.tiny_config(gc_free_threshold=100, gc_victims_per_pass=k)
        s = _pressure_state(cfg, 5, n_victim_blocks=6)
        cap0 = int(st.usable_capacity_pages(s, cfg))
        s2 = ftl.gc_step(s, cfg)
        assert float(s2.n_erases) == k
        assert int(st.usable_capacity_pages(s2, cfg)) == cap0

    def test_reclaim_through_shared_kernel_keeps_invariants(self):
        """The fused reclaim demotion (the same relocate_group kernel)
        demotes each victim exactly once with clean invariants."""
        cfg = geometry.tiny_config()
        s = st.init_state(cfg, device=CPU)
        s = ftl.migrate_block(s, 0, modes.TLC, cfg)
        s = ftl.migrate_block(s, 1, modes.TLC, cfg)
        tlc_full = (s.block_mode.numpy() == modes.TLC) & (s.block_state.numpy() == st.FULL)
        victims = torch.from_numpy(np.nonzero(tlc_full)[0][:2].astype(np.int32))
        K = victims.shape[0]
        s2 = ftl.reclaim_victims(
            s, victims, torch.ones((K,), dtype=torch.bool),
            torch.full((K,), modes.QLC, dtype=torch.int32), cfg,
        )
        st.check_invariants(s2, cfg, "reclaim")
        assert (s2.block_state.numpy()[victims.numpy()] == st.FREE).all()
        assert (s2.l2p.numpy() >= 0).all()


class TestOraclesMatchReference:
    """Each sequential oracle of the port against the JAX package's, from the
    same state (the port's pressure state, handed to JAX as numpy)."""

    @staticmethod
    def _both(cfg_kw, seed, n_victim_blocks=6, demote=2):
        import jax.numpy as jnp

        from repro.ssdsim import geometry as j_geo
        from repro.ssdsim import state as j_st

        cfg = geometry.tiny_config(**cfg_kw)
        s = _pressure_state(cfg, seed, n_victim_blocks, demote)
        js = j_st.SSDState(*[jnp.asarray(x.numpy()) for x in s])
        return cfg, j_geo.tiny_config(**cfg_kw), s, js

    @staticmethod
    def _check(js, s, where):
        from repro.ssdsim import state as j_st

        bad = compare_leaves(j_st.SSDState._fields, js, s, where=where)
        assert not bad, "\n".join(bad)

    @pytest.mark.parametrize("seed", [0, 11])
    def test_erase(self, seed):
        import jax.numpy as jnp

        from repro.ssdsim import ftl as j_ftl

        cfg, j_cfg, s, js = self._both({}, seed)
        for blk in (2, 3, 9):  # an SLC, a TLC and a QLC block
            s = ftl._erase(s, blk, cfg)
            js = j_ftl._erase(js, jnp.int32(blk), j_cfg)
            self._check(js, s, f"erase {blk}: ")

    @pytest.mark.parametrize("tgt", [modes.SLC, modes.TLC, modes.QLC])
    def test_migrate_block(self, tgt):
        import jax.numpy as jnp

        from repro.ssdsim import ftl as j_ftl

        cfg, j_cfg, s, js = self._both(dict(initial_pe=700, device_age_h=24.0), 1)
        for src in (9, 12):
            s = ftl._migrate_block_reference(s, src, tgt, cfg)
            js = j_ftl._migrate_block_reference(js, jnp.int32(src), jnp.int32(tgt), j_cfg)
            self._check(js, s, f"migrate {src} -> {tgt}: ")
        assert float(s.n_migrated_pages) > 0

    @pytest.mark.parametrize("seed", [0, 7])
    def test_gc_pass_and_step(self, seed):
        from repro.ssdsim import ftl as j_ftl

        kw = dict(gc_free_threshold=50, gc_victims_per_pass=1, initial_pe=300)
        cfg, j_cfg, s, js = self._both(kw, seed, n_victim_blocks=5)
        erases0 = float(s.n_erases)
        for step in range(3):
            s = ftl.gc_pass_reference(s, cfg)
            js = j_ftl.gc_pass_reference(js, j_cfg)
            self._check(js, s, f"gc pass {step}: ")
        s = ftl.gc_step_reference(s, cfg)
        js = j_ftl.gc_step_reference(js, j_cfg)
        self._check(js, s, "gc step: ")
        assert float(s.n_erases) == erases0 + 4  # every pass found a victim
