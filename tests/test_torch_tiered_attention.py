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

from repro.core import modes as j_modes
from repro.kernels.tiered_attention.ops import tiered_decode_attention as j_tda
from repro.kernels.tiered_attention.ref import tiered_decode_attention_ref as j_tda_ref
from repro.kernels.tiered_attention.tiered_attention import tiered_decode_partial as j_partial
from repro.kvcache import paged as j_paged
from repro.kvcache import tiers as j_tiers
from repro_torch import convert
from repro_torch.kernels.tiered_attention.ops import tiered_decode_attention
from repro_torch.kernels.tiered_attention.ref import tiered_decode_attention_ref
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
