"""Twin of tests/test_kvcache_policy.py: the port's RARO KV-tier controller
(``repro_torch.kvcache.{paged,tiers}``: ``commit_tier``, ``append``,
``raro_step``, ``page_retry_estimate``) must do on KV pages what the
paper's FTL does on flash blocks, held by the reference's six behavioural
cases on the CPU with the same configs, token counts and masses. The
reference draws each token's K and V with ``jax.random``; here they are
numpy draws from the same seed. One case, hot pages promoted, also runs
the JAX package's controller on the same numpy K, V and masses and holds
every cache leaf (tier and slot tables, free masks, pools, counters) and
``page_retry_estimate`` equal to the reference's."""

import numpy as np
import torch
from test_torch_parity import assert_cache_equal
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)

from repro_torch.core import hotness, modes
from repro_torch.kvcache import paged, tiers


def _cfg(**kw):
    base = dict(n_seqs=2, max_pages=8, page_size=4, n_kv_heads=2, head_dim=8,
                pool_pages=(8, 8, 64), migrate_per_step=4)
    base.update(kw)
    return paged.CacheConfig(**base)


def _draws(cfg, n_tokens, key):
    """Each token's K and V per sequence, (n_tokens, B, Hk, Dh) f32."""
    rng = np.random.default_rng(key)
    shape = (n_tokens, cfg.n_seqs, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _fill(cfg, rcfg, n_tokens, key=0, masses_fn=None):
    c = paged.init(cfg, torch.float32, "cpu")
    ks, vs = _draws(cfg, n_tokens, key)
    for t in range(n_tokens):
        ct = tiers.commit_tier(c, cfg, rcfg)
        c = paged.append(c, cfg, torch.from_numpy(ks[t]), torch.from_numpy(vs[t]), ct)
        masses = (torch.from_numpy(masses_fn(t)) if masses_fn
                  else torch.zeros((cfg.n_seqs, cfg.max_pages)))
        c, _ = tiers.raro_step(c, cfg, rcfg, masses)
    return c


def _hot_first_page(t):
    m = np.zeros((2, 8), np.float32)
    m[:, 0] = 0.6  # heavy attention on the first page
    return m


def test_cold_pages_stay_dense():
    """No attention mass -> everything commits and stays at int4 (QLC)."""
    cfg = _cfg()
    c = _fill(cfg, tiers.RAROConfig(), 24)
    t = c.tier.numpy()
    committed = t[t >= 0]
    assert (committed == modes.TIER_INT4).all()


def test_hot_pages_get_promoted():
    """Concentrated attention on page 0 -> it is promoted out of int4."""
    cfg = _cfg()
    rcfg = tiers.RAROConfig()
    c = _fill(cfg, rcfg, 24, masses_fn=_hot_first_page)
    t = c.tier.numpy()
    assert (t[:, 0] == modes.TIER_BF16).all(), t[:, 0]
    # later (cold) pages stay dense
    assert (t[:, 2][t[:, 2] >= 0] == modes.TIER_INT4).all()


def test_hot_pages_get_promoted_equals_reference():
    """The same case through the JAX package's controller, on the same numpy
    K, V and masses: every cache leaf and the retry estimate equal."""
    import jax.numpy as jnp

    from repro.kvcache import paged as j_paged
    from repro.kvcache import tiers as j_tiers

    cfg = _cfg()
    jcfg = j_paged.CacheConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    rcfg, jr = tiers.RAROConfig(), j_tiers.RAROConfig()
    c = _fill(cfg, rcfg, 24, masses_fn=_hot_first_page)
    jc = j_paged.init(jcfg, jnp.float32)
    ks, vs = _draws(cfg, 24, 0)
    for t in range(24):
        jc = j_paged.append(jc, jcfg, jnp.asarray(ks[t]), jnp.asarray(vs[t]),
                            j_tiers.commit_tier(jc, jcfg, jr))
        jc, _ = j_tiers.raro_step(jc, jcfg, jr, jnp.asarray(_hot_first_page(t)))
    assert_cache_equal(jc, c)
    np.testing.assert_array_equal(tiers.page_retry_estimate(c, rcfg).numpy(),
                                  np.asarray(j_tiers.page_retry_estimate(jc, jr)))
    assert (c.tier.numpy() == modes.TIER_BF16).any()  # the case promoted


def test_disabled_controller_is_static_int4():
    cfg = _cfg()
    rcfg = tiers.RAROConfig(enabled=False)
    c = _fill(cfg, rcfg, 24, masses_fn=lambda t: np.full((2, 8), 0.4, np.float32))
    t = c.tier.numpy()
    assert (t[t >= 0] == modes.TIER_INT4).all()


def test_retry_estimate_grows_with_reads_and_density():
    cfg = _cfg()
    c = _fill(cfg, tiers.RAROConfig(), 16)
    lo = tiers.page_retry_estimate(c, tiers.RAROConfig())
    c2 = c._replace(reads=c.reads + 50.0)
    hi = tiers.page_retry_estimate(c2, tiers.RAROConfig())
    t = c.tier.numpy()
    sel = t >= 0
    assert (hi.numpy()[sel] >= lo.numpy()[sel]).all()
    assert hi.numpy()[sel].max() > 0


def test_elastic_recovery_demotes_under_pressure():
    """Fill the bf16 pool, cool everything -> demotions kick in."""
    cfg = _cfg(pool_pages=(2, 4, 64), high_watermark=0.4)
    # fast heat decay so pages actually go COLD within the test horizon
    rcfg = tiers.RAROConfig(heat=hotness.HeatConfig(decay=0.6, hot_thresh=0.08,
                                                    warm_thresh=0.02))
    hot_then_cold = [0.6] * 12 + [0.0] * 24

    def masses(t):
        m = np.zeros((2, 8), np.float32)
        m[:, :2] = hot_then_cold[min(t, len(hot_then_cold) - 1)]
        return m

    c = _fill(cfg, rcfg, 36, masses_fn=masses)
    occ0 = float(1.0 - c.free[0].float().mean())
    # bf16 pool pressure relieved by demotion of cooled pages
    assert occ0 <= 0.5 + 1e-6, occ0


def test_capacity_accounting_matches_tiers():
    cfg = _cfg()
    c = _fill(cfg, tiers.RAROConfig(), 24)
    p, hk, dh = cfg.page_size, cfg.n_kv_heads, cfg.head_dim
    t = c.tier.numpy()
    per = {0: 2 * p * hk * dh * 2, 1: 2 * p * hk * dh, 2: p * hk * dh}
    expect = sum(per[int(x)] for x in t[t >= 0])
    assert paged.memory_bytes(c, cfg) == expect
