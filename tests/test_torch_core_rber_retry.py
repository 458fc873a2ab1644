"""Twin of tests/test_core_rber_retry.py: the Eq.(1) RBER model and the
Eq.(2)/(3) retry model of the port (``repro_torch.core``), held by the
reference's own assertions on the CPU, with the same seeds and sizes; and
the calibration draw held against the JAX package's, exactly."""

import numpy as np
import pytest
import torch
from torch_twins import f32, i32, one_torch_thread  # noqa: F401 (an autouse fixture)

from repro_torch.core import modes, policy, rber, retry

QLC, TLC, SLC = (i32(m) for m in (modes.QLC, modes.TLC, modes.SLC))


class TestRBER:
    def test_monotone_in_cycles(self):
        c = f32([0.0, 100.0, 400.0, 900.0])
        r = rber.rber(QLC, c, f32(10.0), f32(10.0))
        assert np.all(np.diff(r.numpy()) > 0)

    def test_monotone_in_time_and_reads(self):
        base = rber.rber(QLC, f32(500.0), f32(10.0), f32(10.0))
        assert rber.rber(QLC, f32(500.0), f32(200.0), f32(10.0)) > base
        assert rber.rber(QLC, f32(500.0), f32(10.0), f32(2000.0)) > base

    def test_mode_ordering(self):
        # Denser modes are strictly less reliable at identical stress.
        stress = (f32(500.0), f32(100.0), f32(100.0))
        s = rber.rber(SLC, *stress)
        t = rber.rber(TLC, *stress)
        q = rber.rber(QLC, *stress)
        assert s < t < q

    def test_page_variation_deterministic_and_centered(self):
        ids = torch.arange(50_000)
        f = rber.page_variation(ids).numpy()
        f2 = rber.page_variation(ids).numpy()
        np.testing.assert_array_equal(f, f2)
        # lognormal(0, sigma): median ~ 1
        assert 0.95 < np.median(f) < 1.05
        assert np.all(f > 0)


class TestRetry:
    def test_zero_retries_when_ldpc_corrects_first_read(self):
        # RBER small enough that a * RBER * n_sense <= E_LDPC
        n = retry.retry_count(QLC, f32(retry.E_LDPC_RATE / 8.0 * 0.9))
        assert int(n) == 0

    def test_eq3_inverse(self):
        # Check Eq.(2) holds at the returned count: RBER*ns*(1-d)^n <= E.
        for r in [2e-3, 5e-3, 1e-2, 3e-2]:
            n = int(retry.retry_count(QLC, f32(r)))
            lhs = r * 8 * (1 - retry.DELTA) ** n
            assert lhs <= retry.E_LDPC_RATE or n == int(modes.MAX_RETRIES[modes.QLC])

    def test_clipped_to_table_max(self):
        n = retry.retry_count(QLC, f32(0.5))
        assert int(n) == int(modes.MAX_RETRIES[modes.QLC])

    def test_latency_model_matches_fig4(self):
        # Fig 4: 1 retry => -50% bandwidth (2x latency); 10 retries => ~-92%.
        base = float(retry.read_latency_us(QLC, i32(0)))
        one = float(retry.read_latency_us(QLC, i32(1)))
        ten = float(retry.read_latency_us(QLC, i32(10)))
        assert one == pytest.approx(2 * base)
        assert 1 - base / ten == pytest.approx(0.909, abs=0.02)


class TestCalibration:
    """DESIGN.md §6 — distributions must land in the paper's Fig. 5/6 bands."""

    @pytest.fixture(scope="class")
    def pages(self):
        return torch.arange(20_000, dtype=torch.int32)

    def _dist(self, mode, lo, hi, pages, seed=0):
        # "typical workload stress": pages in blocks that have accumulated
        # reads (Fig. 6 is measured during the Zipf read workload)
        cyc = np.random.RandomState(seed).uniform(lo, hi, len(pages))
        return retry.page_retries(i32(mode), f32(cyc), f32(100.0), f32(2000.0), pages).numpy()

    def test_qlc_young(self, pages):
        n = self._dist(modes.QLC, 0, 333, pages)
        assert 4 <= np.median(n) <= 7
        assert np.percentile(n, 95) <= 11

    def test_qlc_middle(self, pages):
        n = self._dist(modes.QLC, 334, 666, pages)
        assert 7 <= np.median(n) <= 12

    def test_qlc_old(self, pages):
        n = self._dist(modes.QLC, 667, 1000, pages)
        assert 11 <= np.median(n) <= 15
        # paper: max-retry (16) pages ~ 9.71% at old stage
        assert 0.04 <= np.mean(n == 16) <= 0.18

    def test_lightly_stressed_pages_sit_below_r2(self, pages):
        # Paper §V-C picks R2 at the LOW end of each stage band: warm data in
        # lightly-read blocks must mostly NOT pass R2 (this is what saves
        # capacity vs the Hotness scheme).
        for (lo, hi), r2 in [((0, 333), 5), ((334, 666), 7), ((667, 1000), 11)]:
            cyc = np.random.RandomState(1).uniform(lo, hi, len(pages))
            n = retry.page_retries(QLC, f32(cyc), f32(24.0), f32(50.0), pages).numpy()
            assert np.mean(n >= r2) < 0.40

    def test_heavily_read_pages_rise_above_r2(self, pages):
        # ... while read-disturbed hot blocks DO pass (the trigger works).
        for (lo, hi), r2 in [((0, 333), 5), ((334, 666), 7), ((667, 1000), 11)]:
            cyc = np.random.RandomState(2).uniform(lo, hi, len(pages))
            n = retry.page_retries(QLC, f32(cyc), f32(100.0), f32(5000.0), pages).numpy()
            assert np.mean(n >= r2) > 0.60

    def test_tlc_much_less_severe_than_qlc(self, pages):
        for lo, hi in [(0, 333), (334, 666), (667, 1000)]:
            q = self._dist(modes.QLC, lo, hi, pages)
            t = self._dist(modes.TLC, lo, hi, pages)
            assert np.median(t) <= np.median(q) - 3

    def test_fresh_tlc_at_most_one_retry(self, pages):
        # paper §V-C: converted TLC "does not exceed 1" retry under typical
        # load -> this is why R1 = 1.
        n = retry.page_retries(TLC, f32(500.0), f32(0.5), f32(1.0), pages).numpy()
        assert np.percentile(n, 99) <= policy.DEFAULT_R1

    def test_slc_retry_free(self, pages):
        n = retry.page_retries(SLC, f32(900.0), f32(500.0), f32(10_000.0), pages).numpy()
        assert n.max() == 0

    @pytest.mark.parametrize("mode", [modes.QLC, modes.TLC])
    def test_distribution_equals_reference(self, pages, mode):
        """The calibration draw of every stage, page for page, equal to the
        JAX package's (integers exact)."""
        import jax.numpy as jnp

        from repro.core import retry as j_retry

        for seed, (lo, hi) in enumerate([(0, 333), (334, 666), (667, 1000)]):
            cyc = np.random.RandomState(seed).uniform(lo, hi, len(pages))
            ref = np.asarray(j_retry.page_retries(mode, cyc, 100.0, 2000.0,
                                                  jnp.arange(len(pages))))
            out = self._dist(mode, lo, hi, pages, seed=seed)
            assert out.dtype == ref.dtype
            np.testing.assert_array_equal(out, ref)
