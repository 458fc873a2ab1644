"""Shared helpers of the port's parity tests (repro_torch against repro on the
CPU), and the tests of the converters that carry JAX state into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_variant as j_smoke_variant
from repro.configs import tinyllama_1_1b as j_tinyllama
from repro.kvcache import paged as j_paged
from repro.launch import serve as j_serve
from repro.models import base as j_base
from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch.configs.base import smoke_variant
from repro_torch.configs import tinyllama_1_1b
from repro_torch.kvcache import paged
from repro_torch.launch import serve

# TieredKV leaves compared exactly; hot/reads are float sums held to a tolerance
CLOSE_FIELDS = ("hot", "reads")


def to_np(x):
    """A torch tensor or JAX array as numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_cache_equal(jc, tc, rtol=1e-6, atol=1e-7, fields=paged.TieredKV._fields):
    """Every TieredKV leaf of the port equals the reference's: integer and
    stored-page leaves exactly (with the same dtype), hot/reads within
    rtol/atol."""
    for f in fields:
        if f == "free":
            for a, b in zip(jc.free, tc.free):
                np.testing.assert_array_equal(to_np(b), to_np(a), err_msg="free")
            continue
        ref, out = to_np(getattr(jc, f)), to_np(getattr(tc, f))
        assert ref.dtype == out.dtype and ref.shape == out.shape, (f, ref.dtype, out.dtype)
        if f in CLOSE_FIELDS:
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(out, ref, err_msg=f)


def cache_configs(**kw):
    jcfg = j_paged.CacheConfig(**kw)
    return jcfg, paged.CacheConfig(**dataclasses.asdict(jcfg))


def serve_params(cfg_j, cfg_t, seed=0):
    """Reference parameters from the JAX package, and the port's copy."""
    api = j_registry.get_api(cfg_j)
    pj = j_base.materialize(api.specs(), jax.random.PRNGKey(seed), jnp.float32)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), cfg_t, "cpu")
    return pj, pt


def small_configs(kind):
    """(reference cfg, port cfg) at test size: the serve demo at 2 layers, or
    tinyllama's smoke variant at 2 layers in bf16."""
    if kind == "serve_f32":
        return j_serve.serve_cfg(n_layers=2), serve.serve_cfg(n_layers=2)
    cj = j_smoke_variant(j_tinyllama.CONFIG).with_(n_layers=2, dtype=jnp.bfloat16)
    ct = smoke_variant(tinyllama_1_1b.CONFIG).with_(n_layers=2, dtype=torch.bfloat16)
    return cj, ct


@pytest.mark.parametrize("kind", ["serve_f32", "tinyllama_bf16"])
def test_params_from_numpy_splits_layers(kind):
    cj, ct = small_configs(kind)
    pj, pt = serve_params(cj, ct)
    assert len(pt["layers"]) == ct.n_layers
    for i in range(ct.n_layers):
        np.testing.assert_array_equal(to_np(pt["layers"][i]["attn"]["wq"]),
                                      np.asarray(pj["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(to_np(pt["layers"][i]["mlp"]["w_out"]),
                                      np.asarray(pj["layers"]["mlp"]["w_out"][i]))
    np.testing.assert_array_equal(to_np(pt["embed"]["table"]), np.asarray(pj["embed"]["table"]))
    j_n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(pj))
    t_n = sum(t.numel() for t in (v for lp in pt["layers"] for d in lp.values()
                                  for v in d.values()))
    t_n += pt["embed"]["table"].numel() + pt["ln_f"]["scale"].numel()
    assert j_n == t_n


def test_params_from_numpy_rejects_wrong_depth():
    cj, ct = small_configs("serve_f32")
    pj = jax.tree_util.tree_map(np.asarray, serve_params(cj, ct)[0])
    with pytest.raises(ValueError):
        convert.params_from_numpy(pj, ct.with_(n_layers=3), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tieredkv_from_numpy_matches_init(dtype):
    jcfg, tcfg = cache_configs(n_seqs=2, max_pages=4, page_size=4, n_kv_heads=2, head_dim=8,
                               pool_pages=(3, 5, 7))
    jc = j_paged.init(jcfg, getattr(jnp, dtype))
    tc = convert.tieredkv_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    ti = paged.init(tcfg, getattr(torch, dtype), "cpu")
    assert tc.k16.dtype == ti.k16.dtype == getattr(torch, dtype)
    for f in paged.TieredKV._fields:
        a, b = getattr(tc, f), getattr(ti, f)
        for x, y in (zip(a, b) if f == "free" else [(a, b)]):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert torch.equal(x, y), f
    assert_cache_equal(jc, ti)


def test_entry_points_need_a_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = cache_configs(n_seqs=1, max_pages=2, page_size=2, n_kv_heads=1, head_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paged.init(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(steps=1, batch=1)
