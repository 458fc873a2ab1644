"""Parity of the port's tiered paged cache and RARO controller
(kvcache/paged.py, kvcache/tiers.py) with the JAX package's.

Replays tests/test_kernels.py::_build_cache in both frameworks with the same
numpy k, v and masses, and compares every TieredKV leaf after every
``append`` and ``raro_step``: page tables, free masks, counters and pools
exactly; hot/reads (float sums) within rtol 1e-6 / atol 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged as j_paged
from repro.kvcache import tiers as j_tiers
from repro_torch.kvcache import paged, tiers
from test_torch_parity import assert_cache_equal, cache_configs, to_np


def replay(b, mp, p, hk, d, steps, seed, pool_pages=None, mass_scale=0.05, density=1.0,
           migrate=2, mixed=True):
    """Drive both caches through the same appends and controller steps;
    returns counts of what the run exercised. The reference runs op by op,
    as the serve loop runs it: under jit, XLA turns the division by qmax into
    a multiplication by its reciprocal, and a scale can move by an ulp."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_configs(n_seqs=b, max_pages=mp, page_size=p, n_kv_heads=hk,
                               head_dim=d, pool_pages=pool_pages or (mp * b,) * 3,
                               migrate_per_step=migrate)
    jr, tr = j_tiers.RAROConfig(), tiers.RAROConfig()
    jc, tc = j_paged.init(jcfg, jnp.float32), paged.init(tcfg, torch.float32, "cpu")
    seen = {"fallback": 0, "promoted": 0, "demoted": 0, "tiers": set()}
    for t in range(steps):
        k1 = (rng.standard_normal((b, hk, d)) * 0.5).astype(np.float32)
        v1 = (rng.standard_normal((b, hk, d)) * 0.5).astype(np.float32)
        jct, tct = j_tiers.commit_tier(jc, jcfg, jr), tiers.commit_tier(tc, tcfg, tr)
        np.testing.assert_array_equal(to_np(tct), np.asarray(jct))
        full = (np.asarray(jc.seq_len) + 1) % p == 0
        jc = j_paged.append(jc, jcfg, jnp.asarray(k1), jnp.asarray(v1), jct)
        tc = paged.append(tc, tcfg, torch.tensor(k1), torch.tensor(v1), tct)
        assert_cache_equal(jc, tc)
        page = np.minimum((np.asarray(jc.seq_len) - 1) // p, mp - 1)
        landed = np.asarray(jc.tier)[np.arange(b), page]
        seen["fallback"] += int((full & (landed > np.asarray(jct))).sum())
        if mixed and t % 3 == 0:
            masses = rng.random((b, mp)) * mass_scale * (rng.random((b, mp)) < density)
            masses = masses.astype(np.float32)
            jc, jst = j_tiers.raro_step(jc, jcfg, jr, jnp.asarray(masses))
            tc, tst = tiers.raro_step(tc, tcfg, tr, torch.tensor(masses))
            assert_cache_equal(jc, tc)
            assert jst.keys() == tst.keys()
            for k in jst:
                assert int(tst[k]) == int(jst[k]), k
                seen["promoted" if k.startswith("promoted") else "demoted"] += int(jst[k])
        seen["tiers"] |= set(np.asarray(jc.tier).ravel().tolist()) - {-1}
    return seen


@pytest.mark.parametrize("shape", [
    # (B, MP, P, Hk, G, D, steps) of tests/test_kernels.py::TestTieredAttention
    (2, 6, 4, 2, 2, 16, 18),
    (1, 4, 8, 1, 4, 32, 25),
    (3, 8, 4, 4, 1, 64, 30),
])
def test_replay_build_cache(shape):
    b, mp, p, hk, _, d, steps = shape
    seen = replay(b, mp, p, hk, d, steps, seed=sum(shape))
    assert seen["promoted"] > 0


def test_full_pools_fall_back_and_demote():
    # tiny bf16/int8 pools and heavy, sparse masses: hot pages fill tier 0 and tier 1,
    # commits fall back to a denser tier (paged.append) and the controller
    # demotes cold pages under pool pressure (tiers.raro_step)
    seen = replay(4, 16, 2, 2, 8, 24, seed=1, pool_pages=(3, 4, 64), mass_scale=0.4,
                  density=0.2)
    assert seen["fallback"] > 0
    assert seen["demoted"] > 0
    assert seen["promoted"] > 0
    assert seen["tiers"] == {0, 1, 2}


def test_static_tiers_when_disabled():
    jcfg, tcfg = cache_configs(n_seqs=2, max_pages=4, page_size=2, n_kv_heads=1, head_dim=4)
    jr, tr = j_tiers.RAROConfig(enabled=False), tiers.RAROConfig(enabled=False)
    jc, tc = j_paged.init(jcfg, jnp.float32), paged.init(tcfg, torch.float32, "cpu")
    np.testing.assert_array_equal(to_np(tiers.commit_tier(tc, tcfg, tr)),
                                  np.asarray(j_tiers.commit_tier(jc, jcfg, jr)))
    masses = np.full((2, 4), 0.5, np.float32)
    jc, jst = j_tiers.raro_step(jc, jcfg, jr, jnp.asarray(masses))
    tc, tst = tiers.raro_step(tc, tcfg, tr, torch.tensor(masses))
    assert jst == tst == {}
    assert_cache_equal(jc, tc)


def test_alloc_hands_out_lowest_free_slots_first():
    rng = np.random.default_rng(0)
    for _ in range(20):
        free = rng.random(9) < 0.5
        want = rng.random(5) < 0.7
        js, jf = j_paged._alloc(jnp.asarray(free), jnp.asarray(want))
        ts, tf = paged._alloc(torch.tensor(free), torch.tensor(want))
        np.testing.assert_array_equal(to_np(ts), np.asarray(js))
        np.testing.assert_array_equal(to_np(tf), np.asarray(jf))


def test_topk_ties_go_to_the_lower_index():
    score = np.array([[0.5, 1.0, 0.5, -np.inf], [1.0, 0.5, -np.inf, 0.5]], np.float32)
    for m in (1, 3, 5, 8):
        jb, jp = j_tiers._topk_pages(jnp.asarray(score), m)
        tb, tp = tiers._topk_pages(torch.tensor(score), m)
        np.testing.assert_array_equal(to_np(tb), np.asarray(jb))
        np.testing.assert_array_equal(to_np(tp), np.asarray(jp))


def test_memory_and_occupancy():
    jcfg, tcfg = cache_configs(n_seqs=2, max_pages=4, page_size=2, n_kv_heads=2, head_dim=8,
                               pool_pages=(2, 3, 8))
    jc, tc = j_paged.init(jcfg, jnp.float32), paged.init(tcfg, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    for t in range(6):
        k1 = rng.standard_normal((2, 2, 8)).astype(np.float32)
        ct = np.array([t % 3, (t + 1) % 3], np.int32)
        jc = j_paged.append(jc, jcfg, jnp.asarray(k1), jnp.asarray(-k1), jnp.asarray(ct))
        tc = paged.append(tc, tcfg, torch.tensor(k1), torch.tensor(-k1), torch.tensor(ct))
    assert_cache_equal(jc, tc)
    assert paged.memory_bytes(tc, tcfg) == j_paged.memory_bytes(jc, jcfg)
    np.testing.assert_array_equal([float(o) for o in paged.pool_occupancy(tc)],
                                  [float(o) for o in j_paged.pool_occupancy(jc)])
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for a, r in zip(paged.gather_kv(tc, tcfg, dt_t), j_paged.gather_kv(jc, jcfg, dt_j)):
            np.testing.assert_array_equal(to_np(a), to_np(r))
