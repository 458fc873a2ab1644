"""Parity of the port's tiered paged cache and RARO controller
(kvcache/paged.py, kvcache/tiers.py) with the JAX package's.

Replays tests/test_kernels.py::_build_cache in both frameworks with the same
numpy k, v and masses, and compares every TieredKV leaf after every
``append`` and ``raro_step``: page tables, free masks, counters and pools
exactly; hot/reads (float sums) within rtol 1e-6 / atol 1e-7. Also: ``append``
and ``_move_pages`` leave their input as it was, and how many calls of the
store entry (kernel launches on a card) each makes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged as j_paged
from repro.kvcache import tiers as j_tiers
from repro_torch.core import modes
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


def _mixed_cache(seed=3):
    """Both caches after a replay-like run that commits pages to all three
    tiers, with the RARO controller on."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_configs(n_seqs=3, max_pages=6, page_size=2, n_kv_heads=2, head_dim=8,
                               pool_pages=(8, 8, 18), migrate_per_step=3)
    jc, tc = j_paged.init(jcfg, jnp.float32), paged.init(tcfg, torch.float32, "cpu")
    for t in range(9):
        k1 = rng.standard_normal((3, 2, 8)).astype(np.float32)
        ct = np.array([t % 3, (t + 1) % 3, (t + 2) % 3], np.int32)
        jc = j_paged.append(jc, jcfg, jnp.asarray(k1), jnp.asarray(-k1), jnp.asarray(ct))
        tc = paged.append(tc, tcfg, torch.tensor(k1), torch.tensor(-k1), torch.tensor(ct))
    assert_cache_equal(jc, tc)
    assert set(to_np(tc.tier).ravel().tolist()) == {-1, 0, 1, 2}
    return jcfg, tcfg, jc, tc


def _snapshot(c):
    return [tuple(t.clone() for t in f) if isinstance(f, tuple) else f.clone() for f in c]


def _assert_unchanged(c, snap):
    for name, f, s in zip(paged.TieredKV._fields, c, snap):
        for a, b in zip(f if isinstance(f, tuple) else (f,), s if isinstance(s, tuple) else (s,)):
            assert torch.equal(a, b), f"{name} was written in place"


def test_append_and_move_pages_leave_their_input_alone():
    _, tcfg, _, tc = _mixed_cache()
    snap = _snapshot(tc)
    rng = np.random.default_rng(0)
    k1 = torch.tensor(rng.standard_normal((3, 2, 8)).astype(np.float32))
    for _ in range(2):  # the second append fills the open pages and commits them
        out = paged.append(tc, tcfg, k1, -k1, torch.tensor([0, 1, 2], dtype=torch.int32))
        _assert_unchanged(tc, snap)
        tc, snap = out, _snapshot(out)
    committed = np.argwhere(to_np(tc.tier) >= 0)
    sel_b = torch.tensor(committed[:3, 0], dtype=torch.int32)
    sel_p = torch.tensor(committed[:3, 1], dtype=torch.int32)
    for tgt in (0, 1, 2):
        out, moved = tiers._move_pages(tc, tcfg, sel_b, sel_p, tgt)
        _assert_unchanged(tc, snap)
        assert int(moved) > 0


@pytest.mark.parametrize("tgt", [0, 1, 2])
def test_move_pages_padded_lanes_do_not_clobber_page_0_0(tgt):
    """-1-padded lanes clamp to (0, 0); with logical page (0, 0) itself moved
    in another lane, the padded ones must not write over its table entries."""
    jcfg, tcfg, jc, tc = _mixed_cache()
    if int(to_np(tc.tier)[0, 0]) == tgt:  # move it away first
        other = (tgt + 1) % 3
        jc, _ = j_tiers._move_pages(jc, jcfg, jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
                                    other)
        tc, _ = tiers._move_pages(tc, tcfg, torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32), other)
    sel_b, sel_p = np.array([-1, 0, -1], np.int32), np.array([-1, 0, -1], np.int32)
    jout, jn = j_tiers._move_pages(jc, jcfg, jnp.asarray(sel_b), jnp.asarray(sel_p), tgt)
    tout, tn = tiers._move_pages(tc, tcfg, torch.tensor(sel_b), torch.tensor(sel_p), tgt)
    assert int(jn) == int(tn) == 1
    assert int(to_np(tout.tier)[0, 0]) == tgt
    assert_cache_equal(jout, tout)


def test_one_store_call_per_append_and_per_quantizing_move(monkeypatch):
    """``append`` stores every committed page with one call of the store
    entry, whatever tiers the pages land in; ``raro_step`` makes one for each
    of its three moves into int8 or int4, and none for the move into bf16 —
    the kernel launches the serve loop makes per layer and step."""
    calls = []

    def counted(fn):
        def store(*a, **kw):
            calls.append(kw.get("tiers"))
            return fn(*a, **kw)
        return store

    monkeypatch.setattr(paged, "quant_store_pages", counted(paged.quant_store_pages))
    monkeypatch.setattr(tiers, "quant_store_pages", counted(tiers.quant_store_pages))
    _, tcfg, _, tc = _mixed_cache()
    k1 = torch.ones((3, 2, 8))
    calls.clear()
    tc = paged.append(tc, tcfg, k1, k1, torch.tensor([0, 1, 2], dtype=torch.int32))
    assert calls == [None]
    calls.clear()
    masses = torch.tensor(np.random.default_rng(1).random((3, 6)).astype(np.float32))
    tiers.raro_step(tc, tcfg, tiers.RAROConfig(), masses)
    assert calls == [(modes.TIER_INT8,), (modes.TIER_INT8,), (modes.TIER_INT4,)]
    calls.clear()
    tiers.raro_step(tc, tcfg, tiers.RAROConfig(enabled=False), masses)
    assert calls == []
