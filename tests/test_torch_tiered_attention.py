"""Parity of the port's tiered decode attention (the plain version of the
``tiered_decode_partial`` kernel, its combiner and its oracle) with the JAX
package's Pallas kernel in interpret mode and its oracle.

The cache is built by the JAX package (the three shapes of
tests/test_kernels.py::TestTieredAttention, from numpy inputs) and carried
over with ``tieredkv_from_numpy``. Tolerances are those of
tests/test_kernels.py: out atol 1e-5, page mass atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import modes as j_modes
from repro.kernels.tiered_attention.ops import tiered_decode_attention as j_tda
from repro.kernels.tiered_attention.ref import tiered_decode_attention_ref as j_tda_ref
from repro.kernels.tiered_attention.tiered_attention import tiered_decode_partial as j_partial
from repro.kvcache import paged as j_paged
from repro.kvcache import tiers as j_tiers
from repro_torch import convert
from repro_torch.kernels.tiered_attention.ops import tiered_decode_attention
from repro_torch.kernels.tiered_attention.ref import tiered_decode_attention_ref
from repro_torch.kernels.tiered_attention import tiered_attention as ta
from repro_torch.kernels.tiered_attention.tiered_attention import (
    NEG_INF, tiered_decode_partial, tiered_decode_partial_plain)
from test_torch_parity import cache_configs, to_np

SHAPES = [
    # (B, MP, P, Hk, G, D, steps), and a seed whose cache holds pages of two or
    # more tiers (of all three for the first shape)
    ((2, 6, 4, 2, 2, 16, 18), 5),
    ((1, 4, 8, 1, 4, 32, 25), 7),
    ((3, 8, 4, 4, 1, 64, 30), 7),
]


def build_cache(b, mp, p, hk, d, steps, seed):
    """tests/test_kernels.py::_build_cache, in the JAX package, fed by numpy."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_configs(n_seqs=b, max_pages=mp, page_size=p, n_kv_heads=hk,
                               head_dim=d, pool_pages=(mp * b,) * 3, migrate_per_step=2)
    rcfg = j_tiers.RAROConfig()
    append = jax.jit(j_paged.append, static_argnums=1)
    raro = jax.jit(j_tiers.raro_step, static_argnums=(1, 2))
    c = j_paged.init(jcfg, jnp.float32)
    for t in range(steps):
        k1, v1 = (rng.standard_normal((2, b, hk, d)) * 0.5).astype(np.float32)
        c = append(c, jcfg, k1, v1, j_tiers.commit_tier(c, jcfg, rcfg))
        if t % 3 == 0:
            c, _ = raro(c, jcfg, rcfg, (rng.random((b, mp)) * 0.05).astype(np.float32))
    tc = convert.tieredkv_from_numpy(jax.tree_util.tree_map(np.asarray, c), "cpu")
    return jcfg, c, tcfg, tc


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s[0])))
def case(request):
    (b, mp, p, hk, g, d, steps), seed = request.param
    jcfg, jc, tcfg, tc = build_cache(b, mp, p, hk, d, steps, seed)
    q = np.random.default_rng(11).standard_normal((b, hk * g, d)).astype(np.float32)
    assert len(set(np.asarray(jc.tier).ravel().tolist()) - {-1}) >= 2, "want mixed tiers"
    return jcfg, jc, tcfg, tc, q


def test_attention_matches_pallas_and_oracle(case):
    jcfg, jc, tcfg, tc, q = case
    o, mass = tiered_decode_attention(torch.tensor(q), tc, tcfg)
    for ro, rmass in (j_tda(jnp.asarray(q), jc, jcfg), j_tda_ref(jnp.asarray(q), jc, jcfg)):
        np.testing.assert_allclose(to_np(o), np.asarray(ro), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(to_np(mass), np.asarray(rmass), atol=1e-6)
    m = to_np(mass)
    assert (m >= -1e-6).all() and (m.sum(1) <= 1.0 + 1e-5).all()


def test_oracle_matches_oracle(case):
    jcfg, jc, tcfg, tc, q = case
    o, mass = tiered_decode_attention_ref(torch.tensor(q), tc, tcfg)
    ro, rmass = j_tda_ref(jnp.asarray(q), jc, jcfg)
    np.testing.assert_allclose(to_np(o), np.asarray(ro), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(mass), np.asarray(rmass), atol=1e-6)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_partials_match_pallas_per_tier(case, pool_dtype):
    """All five outputs of each tier's partial, page_p/page_m included:
    page_m is the running max after the page, NEG_INF where skipped."""
    jcfg, jc, _, tc, q = case
    n0, hk = jc.k16.shape[0], jcfg.n_kv_heads
    ones = np.ones((n0, hk), np.float32)
    dt = getattr(jnp, pool_dtype)
    pools = {j_modes.TIER_BF16: (jc.k16.astype(dt), jc.v16.astype(dt), ones, ones)}
    if pool_dtype == "float32":  # the int8/int4 pools do not depend on the tier-0 dtype
        pools[j_modes.TIER_INT8] = (jc.k8, jc.v8, jc.sk8, jc.sv8)
        pools[j_modes.TIER_INT4] = (jc.k4, jc.v4, jc.sk4, jc.sv4)
    for tier, (kp, vp, sk, sv) in pools.items():
        slot_t = np.where(np.asarray(jc.tier) == tier, np.asarray(jc.slot), -1).astype(np.int32)
        ref = j_partial(jnp.asarray(q), kp, vp, sk, sv, slot_t, tier=tier, interpret=True)
        args = [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in (q, kp, vp, sk, sv)]
        out = tiered_decode_partial(*args, torch.tensor(slot_t), tier=tier)
        for name, a, r in zip(("o", "m", "l", "page_p", "page_m"), out, ref):
            np.testing.assert_allclose(to_np(a), np.asarray(r), atol=1e-5, rtol=1e-5,
                                       err_msg=f"tier {tier} {name}")
        skipped = slot_t < 0
        assert (to_np(out[3])[skipped] == 0).all() and (to_np(out[4])[skipped] == NEG_INF).all()


def test_partial_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((2, 4, 8)).astype(np.float32))
    kp = torch.tensor(rng.standard_normal((3, 2, 2, 8)).astype(np.float32))
    ones = torch.ones(3, 2)
    slots = torch.tensor([[0, -1, 2], [-1, 1, -1]], dtype=torch.int32)
    n0 = tiered_decode_partial.launches
    a = tiered_decode_partial(q, kp, kp, ones, ones, slots, tier=0)
    b = tiered_decode_partial_plain(q, kp, kp, ones, ones, slots, tier=0)
    assert tiered_decode_partial.launches == n0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tiered_decode_partial(q.to("meta"), kp, kp, ones, ones, slots, tier=0)


def page_parallel_partial(q, k_pool, v_pool, sk, sv, slot_table, *, tier):
    """The kernel's page-parallel algebra: each page's own max mu, exp-sum
    sigma and P.V acc, taken apart from the others; then one in-order pass for
    the running max pm and page_p = sigma * exp(mu - pm), and m, l and o as the
    valid pages' parts times exp(mu - m)."""
    b, h, d = q.shape
    n, _, hk, _ = k_pool.shape
    g = h // hk
    qh = (q.float() * d**-0.5).reshape(b, hk, g, d)
    mus, sigmas, accs, valids = [], [], [], []
    for j in range(slot_table.shape[1]):
        slot = slot_table[:, j].long()
        s_idx = torch.clamp(slot, 0, n - 1)
        k = ta._dequant_block(k_pool[s_idx], sk[s_idx], tier)
        v = ta._dequant_block(v_pool[s_idx], sv[s_idx], tier)
        s = torch.einsum("bhgd,bphd->bhgp", qh, k)  # the plain version's scores
        mu = s.amax(dim=-1)
        e = torch.exp(s - mu[..., None])
        mus.append(mu)
        sigmas.append(e.sum(dim=-1))
        accs.append(torch.einsum("bhgp,bphd->bhgd", e, v))
        valids.append((slot >= 0)[:, None, None])
    pm = torch.full_like(mus[0], NEG_INF)
    page_p, page_m = [], []
    for mu, sigma, valid in zip(mus, sigmas, valids):
        pm = torch.where(valid, torch.maximum(pm, mu), pm)
        page_p.append(torch.where(valid, sigma * torch.exp(mu - pm), 0.0).reshape(b, h))
        page_m.append(torch.where(valid, pm, NEG_INF).reshape(b, h))
    m = pm
    l, o = torch.zeros_like(m), torch.zeros_like(accs[0])
    for mu, sigma, acc, valid in zip(mus, sigmas, accs, valids):
        w = torch.where(valid, torch.exp(mu - m), 0.0)
        l = l + sigma * w
        o = o + acc * w[..., None]
    return (o.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h),
            torch.stack(page_p, dim=1), torch.stack(page_m, dim=1))


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_page_parallel_algebra_matches_pallas_per_tier(case, pool_dtype):
    """What the kernel computes, pages apart and then one in-order pass, gives
    the serial walk's five outputs: within 1e-5 of the JAX Pallas kernel (in
    interpret mode), as ``test_partials_match_pallas_per_tier`` holds them, and
    page_m and m equal to the plain serial version's bit for bit (the maxima of
    the same scores)."""
    jcfg, jc, _, tc, q = case
    n0, hk = jc.k16.shape[0], jcfg.n_kv_heads
    ones = np.ones((n0, hk), np.float32)
    dt = getattr(jnp, pool_dtype)
    pools = {j_modes.TIER_BF16: (jc.k16.astype(dt), jc.v16.astype(dt), ones, ones)}
    if pool_dtype == "float32":
        pools[j_modes.TIER_INT8] = (jc.k8, jc.v8, jc.sk8, jc.sv8)
        pools[j_modes.TIER_INT4] = (jc.k4, jc.v4, jc.sk4, jc.sv4)
    for tier, (kp, vp, sk, sv) in pools.items():
        slot_t = np.where(np.asarray(jc.tier) == tier, np.asarray(jc.slot), -1).astype(np.int32)
        ref = j_partial(jnp.asarray(q), kp, vp, sk, sv, slot_t, tier=tier, interpret=True)
        args = [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in (q, kp, vp, sk, sv)]
        args.append(torch.tensor(slot_t))
        out = page_parallel_partial(*args, tier=tier)
        serial = tiered_decode_partial_plain(*args, tier=tier)
        for name, a, r in zip(("o", "m", "l", "page_p", "page_m"), out, ref):
            np.testing.assert_allclose(to_np(a), np.asarray(r), atol=1e-5, rtol=1e-5,
                                       err_msg=f"tier {tier} {name}")
        for i in (1, 4):  # m and page_m
            assert torch.equal(out[i], serial[i]), f"tier {tier} output {i}"


def test_cuda_tensors_reach_the_partial_kernel(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel (mocked here: fake CUDA
    tensors, a recording stand-in for the ctypes function) with the pool's
    shape, tier and dtype, and never the plain version; a head dim that is not
    a multiple of 4 is refused before any launch."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        return 0

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ta, "_kernel", lambda: fake_launch)
    monkeypatch.setattr(ta, "tiered_decode_partial_plain", no_plain)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 9}))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = tiered_decode_partial.launches
    b, h, hk, d, n, p, mp = 2, 8, 2, 16, 5, 4, 3
    with FakeTensorMode():
        q = torch.empty(b, h, d, device="cuda")
        pool = torch.empty(n, p, hk, d // 2, dtype=torch.int8, device="cuda")
        scales = torch.empty(n, hk, device="cuda")
        slots = torch.empty(b, mp, dtype=torch.int32, device="cuda")
        o, m, l, page_p, page_m = tiered_decode_partial(q, pool, pool, scales, scales, slots,
                                                        tier=2)
        assert o.device.type == "cuda" and o.shape == (b, h, d)
        assert m.shape == l.shape == (b, h) and page_p.shape == page_m.shape == (b, mp, h)
        bf = torch.empty(n, p, hk, d, dtype=torch.bfloat16, device="cuda")
        tiered_decode_partial(q, bf, bf, scales, scales, slots, tier=0)
        q6 = torch.empty(b, h, 6, device="cuda")
        pool6 = torch.empty(n, p, hk, 6, device="cuda")
        with pytest.raises(ValueError, match="multiple of 4"):
            tiered_decode_partial(q6, pool6, pool6, scales, scales, slots, tier=0)
    assert tiered_decode_partial.launches == before + 2 and len(calls) == 2
    (*ptrs4, s4, stream4), (*ptrs0, s0, _) = calls
    assert ptrs4[11:] == [b, h, d, n, p, hk, mp, 2, 0] and stream4 == 9
    assert ptrs0[11:] == [b, h, d, n, p, hk, mp, 0, 1]
    assert s4 == s0 == pytest.approx(d**-0.5)
    assert all(isinstance(x, int) for x in ptrs4[:11])
