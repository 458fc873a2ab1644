"""Twin of tests/test_workload.py: the port's host-side workload generators
(``repro_torch.ssdsim.workload``; numpy, as the reference's), held by the
reference's packing, distribution and determinism assertions with the same
seeds and sizes; and every trace builder's arrays held equal to the JAX
package's."""

import numpy as np
import pytest
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)

from repro_torch.ssdsim import geometry, workload
from repro_torch.ssdsim.engine import OP_READ, OP_WRITE

TINY = geometry.tiny_config()


class TestPack:
    def test_pads_to_chunk_multiple(self):
        n = TINY.chunk + 7  # forces one padded chunk
        lpn = np.arange(n, dtype=np.int32)
        op = np.full(n, OP_READ, np.int32)
        tr = workload._pack(TINY, lpn, op)
        n_chunks = -(-n // TINY.chunk)
        assert tr["lpn"].shape == (n_chunks, TINY.chunk)
        assert tr["op"].shape == (n_chunks, TINY.chunk)

    def test_padding_is_invalid_reads(self):
        n = TINY.chunk - 3
        tr = workload._pack(TINY, np.arange(n, dtype=np.int32),
                            np.full(n, OP_WRITE, np.int32))
        flat_lpn = tr["lpn"].reshape(-1)
        flat_op = tr["op"].reshape(-1)
        # padding lanes are lpn == -1 with a harmless read op
        assert (flat_lpn[n:] == -1).all()
        assert (flat_op[n:] == OP_READ).all()
        # payload is untouched
        np.testing.assert_array_equal(flat_lpn[:n], np.arange(n))
        assert (flat_op[:n] == OP_WRITE).all()

    def test_exact_multiple_has_no_padding(self):
        n = 2 * TINY.chunk
        tr = workload._pack(TINY, np.zeros(n, np.int32), np.full(n, OP_READ, np.int32))
        assert tr["lpn"].shape == (2, TINY.chunk)
        assert (tr["lpn"] >= 0).all()

    def test_dtypes(self):
        tr = workload._pack(TINY, np.arange(10, dtype=np.int64),
                            np.full(10, OP_READ, np.int64))
        assert tr["lpn"].dtype == np.int32 and tr["op"].dtype == np.int32


class TestZipfProbs:
    def test_normalized(self):
        for theta in (0.0, 0.6, 1.2, 2.0):
            p = workload.zipf_probs(1000, theta)
            assert abs(p.sum() - 1.0) < 1e-12
            assert (p >= 0).all()

    def test_monotone_decreasing_in_rank(self):
        p = workload.zipf_probs(100, 1.2)
        assert (np.diff(p) <= 0).all()

    def test_theta_zero_is_uniform(self):
        p = workload.zipf_probs(50, 0.0)
        np.testing.assert_allclose(p, 1.0 / 50)

    def test_higher_theta_more_skewed(self):
        lo = workload.zipf_probs(100, 0.8)
        hi = workload.zipf_probs(100, 1.5)
        assert hi[0] > lo[0]


class TestTraces:
    def test_mixed_trace_read_fraction(self):
        n = 20_000
        tr = workload.mixed_trace(TINY, n, 1.2, read_frac=0.7, seed=0)
        reads = (tr["op"].reshape(-1)[:n] == OP_READ).sum()
        assert abs(reads / n - 0.7) < 0.02  # binomial tolerance

    def test_mixed_trace_write_targets_uniform(self):
        """Regression: write LPNs must be uniform-random over the
        logical space (paper §V-A), not drawn from the Zipf-permuted read
        stream — reads stay heavily skewed, writes must not be."""
        n = 40_000
        tr = workload.mixed_trace(TINY, n, theta=1.2, read_frac=0.5, seed=0)
        lpn = tr["lpn"].reshape(-1)[:n]
        op = tr["op"].reshape(-1)[:n]
        r_lpn = lpn[op == OP_READ]
        w_lpn = lpn[op == OP_WRITE]
        L = TINY.n_logical
        r_counts = np.bincount(r_lpn, minlength=L)
        w_counts = np.bincount(w_lpn, minlength=L)
        # reads: Zipf(1.2) concentrates a large share on the few hottest
        # pages; writes: the most-written page of a uniform draw stays tiny
        assert np.sort(r_counts)[-10:].sum() > 0.2 * len(r_lpn)
        assert w_counts.max() < 0.005 * len(w_lpn)
        # chi-square-style uniformity: variance of uniform multinomial
        # counts stays near its expectation (p ~ n/L per page)
        expect = len(w_lpn) / L
        assert w_counts.var() < 3.0 * expect

    def test_mixed_trace_write_theta_skews_writes(self):
        """``write_theta`` opts into Zipf-skewed overwrites (the gc_pressure
        benchmark workload): hot pages are rewritten repeatedly, while the
        default stays uniform; the write permutation is independent of the
        read permutation."""
        n = 40_000
        tr = workload.mixed_trace(TINY, n, theta=1.2, read_frac=0.5, seed=0,
                                  write_theta=2.0)
        lpn = tr["lpn"].reshape(-1)[:n]
        op = tr["op"].reshape(-1)[:n]
        w_lpn = lpn[op == OP_WRITE]
        w_counts = np.bincount(w_lpn, minlength=TINY.n_logical)
        # Zipf(2.0): the ten hottest write targets dominate the stream
        assert np.sort(w_counts)[-10:].sum() > 0.5 * len(w_lpn)
        # determinism
        tr2 = workload.mixed_trace(TINY, n, theta=1.2, read_frac=0.5, seed=0,
                                   write_theta=2.0)
        np.testing.assert_array_equal(tr["lpn"], tr2["lpn"])

    def test_lpns_in_range(self):
        for tr in (
            workload.zipf_read_trace(TINY, 5_000, 1.2, seed=3),
            workload.uniform_read_trace(TINY, 5_000, seed=3),
            workload.seq_read_trace(TINY, 5_000, start=17),
            workload.mixed_trace(TINY, 5_000, 1.0, seed=3),
        ):
            lpn = tr["lpn"].reshape(-1)
            assert lpn.max() < TINY.n_logical
            assert lpn.min() >= -1

    def test_deterministic_under_fixed_seed(self):
        a = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=9)
        b = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=9)
        np.testing.assert_array_equal(a["lpn"], b["lpn"])
        m1 = workload.mixed_trace(TINY, 4_000, 1.2, seed=9)
        m2 = workload.mixed_trace(TINY, 4_000, 1.2, seed=9)
        np.testing.assert_array_equal(m1["lpn"], m2["lpn"])
        np.testing.assert_array_equal(m1["op"], m2["op"])

    def test_different_seeds_differ(self):
        a = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=1)
        b = workload.zipf_read_trace(TINY, 4_000, 1.2, seed=2)
        assert (a["lpn"] != b["lpn"]).any()

    def test_seq_trace_wraps(self):
        tr = workload.seq_read_trace(TINY, TINY.n_logical + 10, start=0)
        lpn = tr["lpn"].reshape(-1)[: TINY.n_logical + 10]
        np.testing.assert_array_equal(lpn[:5], [0, 1, 2, 3, 4])
        np.testing.assert_array_equal(lpn[TINY.n_logical:], np.arange(10))


@pytest.mark.parametrize("build", [
    lambda w, c: w.zipf_read_trace(c, 5_000, 1.2, seed=3),
    lambda w, c: w.uniform_read_trace(c, 5_000, seed=3),
    lambda w, c: w.seq_read_trace(c, c.n_logical + 10, start=17),
    lambda w, c: w.mixed_trace(c, 40_000, theta=1.2, read_frac=0.5, seed=0, write_theta=2.0),
    lambda w, c: w.mixed_trace(c, 2_000, 1.2, seed=0, arrival_rate=1e4,
                               arrival_dist="constant"),
], ids=["zipf", "uniform", "seq", "mixed_write_theta", "mixed_arrivals"])
def test_traces_equal_reference(build):
    """The same builder of both packages gives the same arrays (integers
    exact, arrival times to the bit)."""
    from repro.ssdsim import geometry as j_geo
    from repro.ssdsim import workload as j_work

    ref, out = build(j_work, j_geo.tiny_config()), build(workload, TINY)
    assert ref.keys() == out.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
