"""Twin of tests/test_core_policy.py: heat classification, the Table-II
policy, controller aggregation and elastic reclaim of the port
(``repro_torch.core``), held by the reference's unit and property tests on
the CPU, with the same hypothesis settings; and the whole Table-II grid
held against the JAX package's, exactly."""

import itertools

import numpy as np
import torch
from hyp_fallback import given, settings, st
from torch_twins import f32, i32, one_torch_thread  # noqa: F401 (an autouse fixture)

from repro_torch.core import controller, hotness, modes, policy, reclaim

CFG = hotness.HeatConfig(decay=0.9, hot_thresh=8.0, warm_thresh=2.0)


def decide(mode, heat, retries, th):
    return int(policy.migration_decision(i32(mode), i32(heat), i32(retries), th))


class TestHotness:
    def test_classify_thresholds(self):
        h = f32([0.0, 1.9, 2.0, 7.9, 8.0, 100.0])
        c = hotness.classify(h, CFG)
        np.testing.assert_array_equal(c.numpy(), [0, 0, 1, 1, 2, 2])

    def test_decay_to_cold(self):
        h = torch.full((4,), 10.0)
        for _ in range(60):
            h = hotness.decay_heat(h, CFG)
        assert int(hotness.classify(h, CFG)[0]) == modes.COLD

    def test_update_accumulates_duplicates(self):
        h = torch.zeros(4)
        h = hotness.update_heat(h, i32([1, 1, 1, 2]), CFG)
        assert float(h[1]) == 3.0 and float(h[2]) == 1.0


class TestTableII:
    def _th(self):
        return policy.Thresholds(i32(1), i32(5))

    def test_qlc_hot_to_slc(self):
        assert decide(modes.QLC, modes.HOT, 1, self._th()) == modes.SLC

    def test_qlc_warm_to_tlc_requires_r2(self):
        th = self._th()
        assert decide(modes.QLC, modes.WARM, 4, th) == modes.QLC
        assert decide(modes.QLC, modes.WARM, 5, th) == modes.TLC

    def test_tlc_hot_to_slc(self):
        assert decide(modes.TLC, modes.HOT, 1, self._th()) == modes.SLC

    def test_cold_never_migrates(self):
        for m in (modes.QLC, modes.TLC, modes.SLC):
            assert decide(m, modes.COLD, 16, self._th()) == m

    def test_slc_never_converts_further(self):
        for h in (modes.COLD, modes.WARM, modes.HOT):
            assert decide(modes.SLC, h, 16, self._th()) == modes.SLC

    def test_below_r1_stays(self):
        assert decide(modes.QLC, modes.HOT, 0, self._th()) == modes.QLC

    def test_stage_r2_schedule(self):
        th = policy.stage_thresholds(i32([100, 500, 900]))
        np.testing.assert_array_equal(th.r2.numpy(), [5, 7, 11])

    @given(
        mode=st.integers(0, 2),
        heat=st.integers(0, 2),
        retries=st.integers(0, 16),
        r1=st.integers(0, 4),
        dr2=st.integers(0, 12),
    )
    @settings(max_examples=200, deadline=None)
    def test_property_monotone_and_no_densification(self, mode, heat, retries, r1, dr2):
        """Invariants: (a) conversion never increases density; (b) RARO
        triggers imply the Hotness scheme would also trigger (RARO is a
        strict filter on Hotness, which is WHY capacity loss shrinks)."""
        th = policy.Thresholds(i32(r1), i32(r1 + dr2))
        t = decide(mode, heat, retries, th)
        assert t <= mode  # never to a denser mode
        h = int(policy.hotness_only_decision(i32(mode), i32(heat)))
        if t != mode:  # RARO migrated => Hotness migrates at least as far down
            assert h <= t

    def test_whole_grid_equals_reference(self):
        """Every (mode, heat, retries, r1, r2) of the property's domain and
        the Hotness scheme's decisions, equal to the JAX package's."""
        import jax.numpy as jnp

        from repro.core import policy as j_policy

        grid = np.array(list(itertools.product(range(3), range(3), range(17), range(5),
                                               range(13))), np.int32)
        mode, heat, retries, r1, dr2 = grid.T
        ref = j_policy.migration_decision(
            jnp.asarray(mode), jnp.asarray(heat), jnp.asarray(retries),
            j_policy.Thresholds(jnp.asarray(r1), jnp.asarray(r1 + dr2)))
        out = policy.migration_decision(i32(mode), i32(heat), i32(retries),
                                        policy.Thresholds(i32(r1), i32(r1 + dr2)))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            policy.hotness_only_decision(i32(mode), i32(heat)).numpy(),
            np.asarray(j_policy.hotness_only_decision(jnp.asarray(mode), jnp.asarray(heat))))


class TestController:
    def test_block_plan_min_target_wins(self):
        # 2 blocks x 3 pages; block 0 has one page wanting SLC, one TLC.
        page_block = i32([0, 0, 0, 1, 1, 1])
        page_mode = torch.full((6,), modes.QLC, dtype=torch.int32)
        page_target = i32([modes.SLC, modes.TLC, modes.QLC, modes.QLC, modes.QLC, modes.QLC])
        valid = torch.ones(6, dtype=torch.bool)
        bm = torch.full((2,), modes.QLC, dtype=torch.int32)
        plan = controller.block_conversion_plan(page_target, page_mode, page_block, valid, 2, bm)
        np.testing.assert_array_equal(plan.numpy(), [modes.SLC, modes.QLC])

    def test_invalid_pages_do_not_trigger(self):
        page_block = i32([0, 0])
        page_mode = torch.full((2,), modes.QLC, dtype=torch.int32)
        page_target = i32([modes.SLC, modes.QLC])
        valid = torch.tensor([False, True])
        bm = torch.full((1,), modes.QLC, dtype=torch.int32)
        plan = controller.block_conversion_plan(page_target, page_mode, page_block, valid, 1, bm)
        assert int(plan[0]) == modes.QLC


class TestReclaim:
    def test_no_demotion_without_pressure(self):
        mode = i32([modes.SLC, modes.TLC])
        m, _ = reclaim.select_demotions(mode, torch.zeros(2), torch.full((2,), 10), 0.9,
                                        reclaim.ReclaimConfig())
        assert int(m.sum()) == 0

    def test_demotes_one_level_only(self):
        mode = i32([modes.SLC, modes.TLC, modes.QLC])
        m, t = reclaim.select_demotions(mode, torch.zeros(3), torch.full((3,), 10), 0.01,
                                        reclaim.ReclaimConfig())
        assert bool(m[0]) and bool(m[1]) and not bool(m[2])
        assert int(t[0]) == modes.TLC and int(t[1]) == modes.QLC

    def test_hysteresis_cold_epochs(self):
        mode = i32([modes.SLC])
        m, _ = reclaim.select_demotions(mode, torch.zeros(1), torch.tensor([1]), 0.01,
                                        reclaim.ReclaimConfig(cold_epochs=4))
        assert int(m.sum()) == 0
