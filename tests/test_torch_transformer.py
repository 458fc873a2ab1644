"""Parity of the port's dense decode path (models/base.py, layers.py,
attention.py, transformer.py, registry.py) with the JAX package's, on the
CPU, with parameters carried over by ``params_from_numpy``.

At serve_cfg() widths in f32, ``decode_step`` logits and KV caches agree
within atol/rtol 1e-4. At tinyllama's smoke variant in bf16 the JAX
``decode_step`` cannot run: its ``lax.scan`` refuses a carry that turns from
bf16 (the embedding) into f32 (after the first residual add with f32
parameters). There the reference is the same layer body unrolled in Python,
from the JAX package's own functions, as its ``launch/serve.py`` unrolls the
tiered step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import base as j_base
from repro.models import layers as j_L
from repro.models import transformer as j_T
from repro_torch.configs import ModelConfig
from repro_torch.models import attention, base, layers, registry, transformer
from test_torch_parity import serve_params, small_configs, to_np

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def j_decode_unrolled(params, cache, tokens, pos, cfg):
    """The JAX package's decode_step body, one Python iteration per layer."""
    b = tokens.shape[0]
    x = j_L.embed(params["embed"], tokens).astype(cfg.dtype)
    s_cache = cache["k"].shape[2]
    widx, bidx = pos % s_cache, jnp.arange(b)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        q, k, v = j_T.qkv(lp["attn"], j_T.norm(cfg, lp["ln1"], x), cfg, pos[:, None])
        kc = cache["k"][i].at[bidx, widx].set(k[:, 0])
        vc = cache["v"][i].at[bidx, widx].set(v[:, 0])
        o = j_attn.decode_attention(q, kc, vc, jnp.minimum(pos + 1, s_cache))
        h = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = h + j_L.mlp(lp["mlp"], j_T.norm(cfg, lp["ln2"], h), cfg.act)
        ks.append(kc)
        vs.append(vc)
    x = j_T.norm(cfg, params["ln_f"], x)
    return j_L.lm_logits(params["embed"], x, cfg.vocab), {"k": jnp.stack(ks), "v": jnp.stack(vs)}


@pytest.mark.parametrize("kind", ["serve_f32", "tinyllama_bf16"])
def test_decode_step_matches_reference(kind):
    cj, ct = small_configs(kind)
    pj, pt = serve_params(cj, ct)
    b, steps = 3, 6
    shape = (ct.n_layers, b, steps + 1, ct.n_kv_heads, ct.head_dim)
    jcache = {k: jnp.zeros(shape, jnp.float32) for k in ("k", "v")}
    tcache = {k: torch.zeros(shape) for k in ("k", "v")}
    j_step = j_T.decode_step if kind == "serve_f32" else j_decode_unrolled
    tokens = np.random.default_rng(4).integers(0, ct.vocab, (steps, b, 1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        lj, jcache = j_step(pj, jcache, jnp.asarray(tokens[t]), jnp.asarray(pos), cj)
        lt, tcache = transformer.decode_step(pt, tcache, torch.tensor(tokens[t]),
                                             torch.tensor(pos), ct)
        assert lt.shape == lj.shape and lt.dtype == torch.float32 == TORCH_DT[lj.dtype.name]
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
        for k in ("k", "v"):
            np.testing.assert_allclose(to_np(tcache[k]), np.asarray(jcache[k]),
                                       atol=1e-4, rtol=1e-4)


def test_decode_step_bf16_rounds_only_the_embedding():
    """With bf16 compute and f32 parameters, x is bf16 once (the embedding) and
    f32 from the first residual add on."""
    cj, ct = small_configs("tinyllama_bf16")
    pt = serve_params(cj, ct)[1]
    cache = {k: torch.zeros(ct.n_layers, 2, 3, ct.n_kv_heads, ct.head_dim) for k in ("k", "v")}
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    x = layers.embed(pt["embed"], tok).to(ct.dtype)
    assert x.dtype == torch.bfloat16
    assert transformer.norm(ct, pt["layers"][0]["ln1"], x).dtype == torch.float32
    logits, _ = transformer.decode_step(pt, cache, tok, torch.zeros(2, dtype=torch.int32), ct)
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(5)
    d, f = 64, 96
    xj = jnp.asarray(rng.standard_normal((2, 5, d)).astype(np.float32), dtype)
    xt = torch.tensor(to_np(xj)).to(TORCH_DT[dtype])
    params = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.tensor(v) for k, v in params.items()}
    for jf, tf in ((j_L.rmsnorm, layers.rmsnorm), (j_L.layernorm, layers.layernorm)):
        a, r = tf(pt, xt), jf(pj, xj)
        assert a.dtype == torch.float32 == TORCH_DT[r.dtype.name]
        np.testing.assert_allclose(to_np(a), np.asarray(r), atol=1e-5, rtol=1e-5)

    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    xr = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    rj = j_L.apply_rope(jnp.asarray(xr, dtype), jnp.asarray(pos), 10000.0)
    rt = layers.apply_rope(torch.tensor(xr).to(TORCH_DT[dtype]), torch.tensor(pos), 10000.0)
    assert rt.dtype == TORCH_DT[rj.dtype.name]
    tol = 1e-5 if dtype == "float32" else 1e-2  # one bf16 ulp where the f32 result rounds
    np.testing.assert_allclose(to_np(rt), to_np(rj), atol=tol, rtol=tol)

    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_in", (d, f)), ("w_gate", (d, f)), ("w_out", (f, d)))}
    for act, keys in (("silu", ("w_in", "w_gate", "w_out")), ("gelu", ("w_in", "w_out"))):
        mj = j_L.mlp({k: jnp.asarray(w[k]) for k in keys}, xj, act)
        mt = layers.mlp({k: torch.tensor(w[k]) for k in keys}, xt, act)
        np.testing.assert_allclose(to_np(mt), np.asarray(mj), atol=1e-5, rtol=1e-5)

    table = rng.standard_normal((layers.padded_vocab(500), d)).astype(np.float32)
    assert layers.padded_vocab(500) == j_L.padded_vocab(500) == 512
    tok = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(to_np(layers.embed({"table": torch.tensor(table)},
                                                     torch.tensor(tok))),
                                  np.asarray(j_L.embed({"table": jnp.asarray(table)}, tok)))
    lt = layers.lm_logits({"table": torch.tensor(table)}, xt, 500)
    lj = j_L.lm_logits({"table": jnp.asarray(table)}, xj, 500)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_matches_reference(window):
    rng = np.random.default_rng(6)
    b, s, h, hk, d = 2, 12, 4, 2, 16
    q1 = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = rng.standard_normal((2, b, s, hk, d)).astype(np.float32)
    cl = np.array([7, 12], np.int32)
    oj = j_attn.decode_attention(q1, k, v, cl, window=window)
    ot = attention.decode_attention(torch.tensor(q1), torch.tensor(k), torch.tensor(v),
                                    torch.tensor(cl), window=window)
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), atol=1e-5, rtol=1e-5)

    q = rng.standard_normal((b, 9, h, d)).astype(np.float32)
    for causal in (True, False):
        rj = j_attn.reference_attention(q, k, v, causal=causal, q_offset=3, kv_len=cl,
                                        window=window)
        rt = attention.reference_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                           causal=causal, q_offset=3, kv_len=torch.tensor(cl),
                                           window=window)
        np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-5, rtol=1e-5)


def by_path(tree, prefix=()):
    """{key path: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items() for p, leaf in by_path(v, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("kind", ["serve_f32", "tinyllama_bf16"])
def test_specs_and_materialize(kind):
    cj, ct = small_configs(kind)
    sj, st = j_T.specs(cj), transformer.specs(ct)
    assert base.n_params(st) == j_base.n_params(sj)
    # the port keeps one spec tree per layer where the reference stacks them
    lj, lt = by_path(sj["layers"]), by_path(st["layers"][0])
    assert lj.keys() == lt.keys()
    for k, s in lj.items():
        assert (s.shape[1:], s.axes[1:], s.init) == (lt[k].shape, lt[k].axes, lt[k].init), k
    gen = torch.Generator().manual_seed(3)
    p1 = base.materialize(st, gen, torch.float32, "cpu")
    p2 = base.materialize(st, torch.Generator().manual_seed(3), torch.float32, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(base.tree_leaves(p1), base.tree_leaves(p2)))
    assert all(a.dtype == torch.float32 for a in base.tree_leaves(p1))
    assert torch.equal(p1["ln_f"]["scale"], torch.ones(ct.d_model))
    emb = p1["embed"]["table"]
    assert emb.shape == (layers.padded_vocab(ct.vocab), ct.d_model)
    assert abs(float(emb.std()) - 0.02) < 0.002  # "normal" init: std 0.02
    wq = p1["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(ct.d_model) - 1.0) < 0.05  # "scaled": 1/sqrt(fan-in)


def test_registry_ports_only_the_dense_family():
    """The registry serves every family of the reference (dense; vlm, which is
    the dense module; moe, with MLA attention or without; encdec, ssm and
    hybrid) and refuses a family the reference does not have."""
    _, ct = small_configs("serve_f32")
    api = registry.get_api(ct)
    assert api.cfg is ct and base.n_params(api.specs()) > 0

    def cfg(fam, **kw):
        return ModelConfig(arch="x", family=fam, n_layers=1, d_model=8, n_heads=1,
                           n_kv_heads=1, d_ff=8, vocab=8, n_experts=2, top_k=1, moe_d_ff=8,
                           **kw)

    for fam in ("moe", "vlm"):
        assert base.n_params(registry.get_api(cfg(fam)).specs()) > 0
    mla = cfg("moe", mla=True, q_lora_rank=4, kv_lora_rank=4, rope_head_dim=2, nope_head_dim=2,
              v_head_dim=2)
    assert "wkv_b" in registry.get_api(mla).specs()["moe_layers"][0]["attn"]
    assert set(registry.get_api(mla).init_cache_specs(1, 4)) == {"moe_ckv", "moe_krope"}
    assert set(registry.get_api(cfg("encdec", n_enc_layers=1, enc_len=4)).specs()) == {
        "embed", "enc_layers", "enc_ln_f", "dec_layers", "ln_f"}
    assert "slstm" in registry.get_api(cfg("ssm", ssm_kind="xlstm")).specs()["layers"][0]
    assert "shared" in registry.get_api(cfg("hybrid", attn_every=1)).specs()
    with pytest.raises(NotImplementedError, match="family"):
        registry.get_api(cfg("rnn"))


def test_vlm_prefill_matches_reference():
    """internvl2's smoke variant with image embeddings: the prefill prepends
    them and counts their positions, as the reference's ``_embed_inputs``
    does. Logits and cache within atol/rtol 1e-4, as the dense prefill."""
    from repro.configs import internvl2_76b as j_internvl2
    from repro.configs.base import smoke_variant as j_smoke_variant
    from repro_torch import convert
    from repro_torch.configs import internvl2_76b
    from repro_torch.configs.base import smoke_variant

    cj = j_smoke_variant(j_internvl2.CONFIG).with_(n_layers=2)
    ct = smoke_variant(internvl2_76b.CONFIG).with_(n_layers=2)
    pj = j_base.materialize(j_T.specs(cj), jax.random.PRNGKey(0), jnp.float32)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")
    rng = np.random.default_rng(8)
    n_img, n_txt = ct.n_img_tokens, 12
    batch = {"tokens": rng.integers(0, ct.vocab, (2, n_txt)).astype(np.int32),
             "img_embeds": rng.standard_normal((2, n_img, ct.d_model)).astype(np.float32)}
    lj, cache_j = j_T.prefill(pj, {k: jnp.asarray(v) for k, v in batch.items()}, cj)
    lt, cache_t = registry.get_api(ct).prefill(pt, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    assert cache_t["k"].shape[2] == n_img + n_txt
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(to_np(cache_t[k]), np.asarray(cache_j[k]), atol=1e-4,
                                   rtol=1e-4)
