"""The whole slice on the CPU: the port's ``launch.serve.tiered_decode_step``
against the JAX package's, 16 teacher-forced steps (two page commits at page
size 8) with RARO on and off, from the same parameters.

Each step: logits within atol 1e-4; the page tables, free masks and counters
of every layer's cache exactly; the hotness and attention-weighted reads, which
sum the per-layer page masses, within atol 1e-6. The stored pages are made from
K and V that the two frameworks' matrix products round differently in the last
bits: the tier-0 pool and the write buffer agree within atol 1e-5, and an int8
or int4 code may sit one step off where K/V lands within an ulp of a rounding
tie, so those pools are held to one quantization step.

At tinyllama's smoke variant in bf16 the step also rounds each layer's
attention output to bf16 before the output projection (the reference's
serve.py:49). Where the two frameworks' sums put that output within 1e-7 of a
bf16 rounding boundary, it rounds one bf16 ulp apart, and the next layers carry
that on: there the logits are held to atol 2e-3, the masses to 1e-5 and the
stored K/V to 1e-3.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged as j_paged
from repro.kvcache import quant as j_quant
from repro.kvcache import tiers as j_tiers
from repro.launch import serve as j_serve
from repro_torch.kvcache import paged, quant, tiers
from repro_torch.launch import serve
from test_torch_parity import assert_cache_equal, serve_params, small_configs, to_np

# jit-compiled: the eager reference spends ~0.3 s a step dispatching small ops
j_step = jax.jit(j_serve.tiered_decode_step, static_argnames=("cache_cfg", "rcfg", "cfg"))
# atol of (logits, hot/reads, stored K/V) per configuration; see the module docstring
TOL = {"serve_f32": (1e-4, 1e-6, 1e-5), "tinyllama_bf16": (2e-3, 1e-5, 1e-3)}
EXACT_FIELDS = ("tier", "slot", "seq_len", "free", "born", "requants", "step", "hot", "reads")


def assert_pools_close(jc, tc, atol):
    for f in ("buf_k", "buf_v", "k16", "v16"):
        np.testing.assert_allclose(to_np(getattr(tc, f)), to_np(getattr(jc, f)), atol=atol,
                                   err_msg=f)
    for codes, scales, unpack in ((("k8", "v8"), ("sk8", "sv8"), lambda a: a),
                                  (("k4", "v4"), ("sk4", "sv4"), None)):
        for cf, sf in zip(codes, scales):
            ct, cj = to_np(getattr(tc, cf)), np.asarray(getattr(jc, cf))
            if unpack is None:
                ct, cj = to_np(quant.unpack_int4(torch.tensor(ct))), np.asarray(
                    j_quant.unpack_int4(jnp.asarray(cj)))
            st, sj = to_np(getattr(tc, sf)), np.asarray(getattr(jc, sf))
            np.testing.assert_allclose(st, sj, rtol=1e-5, err_msg=sf)
            dq = np.abs(ct.astype(np.int32) - cj.astype(np.int32))
            assert dq.max() <= 1 and (dq != 0).mean() < 0.01, cf


@pytest.mark.parametrize("raro", [True, False], ids=["raro", "static"])
@pytest.mark.parametrize("kind", ["serve_f32", "tinyllama_bf16"])
def test_tiered_decode_step_matches_reference(kind, raro):
    cj, ct = small_configs(kind)
    pj, pt = serve_params(cj, ct)
    steps, b = 16, 4
    tol_logits, tol_mass, tol_kv = TOL[kind]
    tcfg = serve.cache_config(ct, steps, b)
    jcfg = j_paged.CacheConfig(**dataclasses.asdict(tcfg))
    jr, tr = j_tiers.RAROConfig(enabled=raro), tiers.RAROConfig(enabled=raro)
    jcs = [j_paged.init(jcfg, jnp.float32) for _ in range(cj.n_layers)]
    tcs = [paged.init(tcfg, torch.float32, "cpu") for _ in range(ct.n_layers)]
    tokens = np.random.default_rng(8).integers(0, ct.vocab, (steps, b, 1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        lj, jcs = j_step(pj, jcs, jcfg, jr, jnp.asarray(tokens[t]), jnp.asarray(pos), cj)
        lt, tcs = serve.tiered_decode_step(pt, tcs, tcfg, tr, torch.tensor(tokens[t]),
                                           torch.tensor(pos), ct)
        assert lt.shape == lj.shape
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=tol_logits, rtol=0)
        for jc, tc in zip(jcs, tcs):
            assert_cache_equal(jc, tc, rtol=0, atol=tol_mass, fields=EXACT_FIELDS)
            assert_pools_close(jc, tc, tol_kv)
    committed = np.stack([np.asarray(c.tier) for c in jcs])
    assert (committed >= 0).sum() == 2 * b * cj.n_layers  # two commits per sequence
    if not raro:
        assert set(committed.ravel().tolist()) == {-1, 2}  # static: every page in int4


def test_run_returns_the_reference_keys():
    # the keys of the dict the reference's run() builds, read from its source
    src = inspect.getsource(j_serve.run)
    keys = re.findall(r'^\s+"(\w+)":', src[src.index("out = {"):], re.M)
    cfg = serve.serve_cfg(n_layers=1)
    out = serve.run(steps=16, batch=2, cfg=cfg, quiet=True, device="cpu")
    assert list(out) == keys
    assert out["tok_per_s"] > 0 and 0 <= out["mean_prob_drift"] < 1
    assert sum(out["tier_pages"]) == 2 * 2  # 16 steps, pages of 8, batch 2, one layer
    assert out["kv_bytes_bf16_equiv"] == 4 * 2 * 8 * cfg.n_kv_heads * cfg.head_dim * 2
    assert 0 <= out["capacity_saving"] < 1 and out["kv_bytes"] > 0
