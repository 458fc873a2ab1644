"""Parity of the port's prefill and dense serving path (models/transformer.py
``prefill``, ``quant_kv``/``dequant_kv``, ``init_cache_specs``, the kv_bits < 16
``decode_step``; models/registry.py; serving/serve_step.py; convert.py) with
the JAX package's, on the CPU, where the prefill's attention is the plain
``blockwise_attention`` as in the reference.

Tolerances: at serve_cfg() widths in f32, prefill logits and the f32 caches
within atol/rtol 1e-4, as ``decode_step`` is held in test_torch_transformer.py.
The int8 / int4 caches are made from K and V that the two frameworks' matrix
products round differently in the last bits, so a code may sit one step off
where K/V lands within an ulp of a rounding tie: codes are held to one step at
under 1% of entries, scales to rtol 1e-5. ``quant_kv`` itself, on the same
inputs, gives codes and scales equal to the eager reference's.

At tinyllama's smoke variant in bf16 the JAX ``prefill`` cannot run: its
``lax.scan`` refuses a carry that turns from bf16 (the embedding) into f32
(after the first residual add with f32 parameters), as its ``decode_step``
does. There the reference is the same layer body unrolled in Python from the
JAX package's own functions. Measured there: logits within 6.0e-7 and the
caches within 2.2e-6 (seeds 0-3, prompt 12); held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import attention as j_attn
from repro.models import base as j_base
from repro.models import layers as j_L
from repro.models import registry as j_registry
from repro.models import transformer as j_T
from repro.serving import serve_step as j_serve_step
from repro_torch import convert
from repro_torch.models import base, registry, transformer
from repro_torch.serving import serve_step
from test_torch_parity import serve_params, small_configs, to_np

B, S = 3, 12


def prompt(cfg, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def with_bits(cj, ct, bits):
    return cj.with_(kv_bits=bits), ct.with_(kv_bits=bits)


def assert_caches_close(tc, jc, bits, atol=1e-4):
    assert set(tc) == set(jc)
    for name in tc:
        t, j = tc[name], np.asarray(jc[name])
        assert to_np(t).dtype == j.dtype and tuple(t.shape) == j.shape, name
        if bits < 16 and name in ("k", "v"):
            ct, cj = to_np(t), j
            if bits == 4:
                ct = to_np(transformer.quant.unpack_int4(t))
                cj = np.asarray(j_T.dequant_kv(jnp.asarray(j), jnp.ones(j.shape[:-1]), 4,
                                               jnp.float32)).astype(np.int8)
            dq = np.abs(ct.astype(np.int32) - cj.astype(np.int32))
            assert dq.max() <= 1 and (dq != 0).mean() < 0.01, name
        elif bits < 16:
            np.testing.assert_allclose(to_np(t), j, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(to_np(t), j, atol=atol, rtol=atol, err_msg=name)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_prefill_matches_reference(bits):
    cj, ct = with_bits(*small_configs("serve_f32"), bits)
    pj, pt = serve_params(cj, ct)
    tok = prompt(ct)
    lj, cache_j = j_T.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    lt, cache_t = transformer.prefill(pt, {"tokens": torch.tensor(tok)}, ct)
    assert lt.shape == lj.shape == (B, 1, ct.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
    assert_caches_close(cache_t, cache_j, bits)


def j_prefill_unrolled(params, tokens, cfg):
    """The JAX package's prefill body, one Python iteration per layer."""
    b, s = tokens.shape
    x = j_L.embed(params["embed"], tokens).astype(cfg.dtype)
    positions = jnp.arange(s)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        q, k, v = j_T.qkv(lp["attn"], j_T.norm(cfg, lp["ln1"], x), cfg, positions)
        o = j_attn.blockwise_attention(q, k, v, causal=True, window=cfg.window)
        h = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        x = h + j_L.mlp(lp["mlp"], j_T.norm(cfg, lp["ln2"], h), cfg.act)
        ks.append(k)
        vs.append(v)
    x = j_T.norm(cfg, params["ln_f"], x)
    logits = j_L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    return logits, {"k": jnp.stack(ks), "v": jnp.stack(vs)}


def test_prefill_bf16_matches_unrolled_reference():
    cj, ct = small_configs("tinyllama_bf16")
    pj, pt = serve_params(cj, ct)
    tok = prompt(ct, seed=8)
    with pytest.raises(TypeError, match="carry"):
        j_T.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    lj, cache_j = j_prefill_unrolled(pj, jnp.asarray(tok), cj)
    lt, cache_t = transformer.prefill(pt, {"tokens": torch.tensor(tok)}, ct)
    assert lt.dtype == torch.float32 and cache_t["k"].dtype == torch.float32
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
    assert_caches_close(cache_t, cache_j, 16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_matches_reference(bits, dtype):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, 5, 4, 32)) * rng.uniform(0.1, 3, (2, 3, 5, 4, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0, 0, :4] = [0.5, -1.5, 2.5, 0]  # an all-but-zero row and exact ties
    x[0, 0, 0, 0, 4:] = 0
    xt = torch.tensor(x).to(getattr(torch, dtype))
    xj = jnp.asarray(to_np(xt), getattr(jnp, dtype))
    qj, sj = j_T.quant_kv(xj, bits)
    qt, st = transformer.quant_kv(xt, bits)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(qt.shape) == qj.shape == x.shape[:-1] + (32 if bits == 8 else 16,)
    np.testing.assert_array_equal(to_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(to_np(st), np.asarray(sj))
    for out_dt in ("float32", "bfloat16"):
        dj = j_T.dequant_kv(qj, sj, bits, getattr(jnp, out_dt))
        dt = transformer.dequant_kv(qt, st, bits, getattr(torch, out_dt))
        assert dt.dtype == getattr(torch, out_dt)
        np.testing.assert_array_equal(to_np(dt), to_np(dj))
    # the int4 codes span [-7, 7]: every nibble unpacks to the value it packed
    if bits == 4:
        full = torch.clamp(torch.round(xt.float() / st[..., None]), -7, 7).to(torch.int8)
        assert torch.equal(transformer.quant.unpack_int4(qt), full)


def pad_cache(cache, extra, xp):
    """The prefill cache lengthened by ``extra`` positions along S (xp: torch or
    jnp): zero codes or values, scale ones, as a caller pads it before decoding
    past the prompt."""
    cat = torch.cat if xp is torch else jnp.concatenate
    return {n: cat([t, (xp.ones_like if n.endswith("scale") else xp.zeros_like)(
        t[:, :, :extra])], 2) for n, t in cache.items()}


@pytest.mark.parametrize("pad", [False, True], ids=["rolling", "padded"])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_prefill_then_decode_matches_reference(bits, pad):
    """Decode after prefill, teacher-forced. Unpadded, the cache is as long as
    the prompt and the reference writes at pos % S, over the first positions:
    the port does the same."""
    steps = 4
    cj, ct = with_bits(*small_configs("serve_f32"), bits)
    pj, pt = serve_params(cj, ct)
    tok = prompt(ct, seed=10)
    _, cache_j = j_T.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    _, cache_t = transformer.prefill(pt, {"tokens": torch.tensor(tok)}, ct)
    if pad:
        cache_t, cache_j = pad_cache(cache_t, steps, torch), pad_cache(cache_j, steps, jnp)
    nxt = np.random.default_rng(11).integers(0, ct.vocab, (steps, B, 1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((B,), S + t, np.int32)
        lj, cache_j = j_T.decode_step(pj, cache_j, jnp.asarray(nxt[t]), jnp.asarray(pos), cj)
        lt, cache_t = transformer.decode_step(pt, cache_t, torch.tensor(nxt[t]), torch.tensor(pos),
                                              ct)
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
        assert_caches_close(cache_t, cache_j, bits)
    assert cache_t["k"].shape[2] == S + steps * pad


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_serve_steps_give_the_reference_greedy_tokens(bits):
    steps = 6
    cj, ct = with_bits(*small_configs("serve_f32"), bits)
    pj, pt = serve_params(cj, ct)
    tok = prompt(ct, seed=12)
    nj, cache_j = j_serve_step.make_prefill(cj)(pj, {"tokens": jnp.asarray(tok)})
    nt, cache_t = serve_step.make_prefill(ct)(pt, {"tokens": torch.tensor(tok)})
    assert nt.dtype == torch.int32 and nt.shape == (B,)
    step_j, step_t = j_serve_step.make_serve_step(cj), serve_step.make_serve_step(ct)
    for t in range(steps):
        np.testing.assert_array_equal(to_np(nt), np.asarray(nj))
        pos = np.full((B,), S + t, np.int32)
        nj, cache_j = step_j(pj, cache_j, nj[:, None], jnp.asarray(pos))
        nt, cache_t = step_t(pt, cache_t, nt[:, None], torch.tensor(pos))
    np.testing.assert_array_equal(to_np(nt), np.asarray(nj))


def test_temperature_sampling_takes_a_generator():
    cj, ct = small_configs("serve_f32")
    pt = serve_params(cj, ct)[1]
    tok = torch.tensor(prompt(ct, seed=13))
    nt, cache = serve_step.make_prefill(ct)(pt, {"tokens": tok})
    pos = torch.full((B,), S, dtype=torch.int32)
    greedy = serve_step.make_serve_step(ct)(pt, cache, nt[:, None], pos)[0]
    hot = serve_step.make_serve_step(ct, temperature=1.0)
    draws = [hot(pt, cache, nt[:, None], pos, torch.Generator().manual_seed(s))[0]
             for s in (0, 0, 1, 2, 3)]
    assert torch.equal(draws[0], draws[1])  # one seed, one draw
    assert all(d.dtype == torch.int32 and bool(((d >= 0) & (d < ct.vocab)).all()) for d in draws)
    assert len({tuple(d.tolist()) for d in draws}) > 1
    # no generator: greedy, as the reference falls back when it gets no key
    assert torch.equal(hot(pt, cache, nt[:, None], pos)[0], greedy)
    cold = serve_step.make_serve_step(ct, temperature=1e-4)
    assert torch.equal(cold(pt, cache, nt[:, None], pos, torch.Generator().manual_seed(0))[0],
                       greedy)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_registry_exposes_prefill_and_cache_specs(bits):
    cj, ct = with_bits(*small_configs("serve_f32"), bits)
    api_t, api_j = registry.get_api(ct), j_registry.get_api(cj)
    sj, st = api_j.init_cache_specs(2, 9), api_t.init_cache_specs(2, 9)
    assert sj.keys() == st.keys()
    for n in sj:
        assert (sj[n].shape, sj[n].axes, sj[n].init) == (st[n].shape, st[n].axes, st[n].init), n
    cache_t = base.materialize(st, torch.Generator(), None, "cpu")
    cache_j = j_base.materialize(sj, jax.random.PRNGKey(0), None)
    for n in sj:
        ref = np.asarray(cache_j[n])
        assert to_np(cache_t[n]).dtype == ref.dtype, n  # int8 codes stay int8
        np.testing.assert_array_equal(to_np(cache_t[n]), ref)
        conv = convert.cache_from_numpy({n: ref}, "cpu")[n]
        assert conv.dtype == cache_t[n].dtype and torch.equal(conv, cache_t[n])
    pt = serve_params(cj, ct)[1]
    tok = torch.tensor(prompt(ct))
    lt, ct_cache = api_t.prefill(pt, {"tokens": tok})
    lt2, _ = transformer.prefill(pt, {"tokens": tok}, ct)
    assert torch.equal(lt, lt2)
    assert {n: t.shape[2:] for n, t in ct_cache.items()} == {
        n: tuple(s.shape[2:3]) + tuple(s.shape[3:]) for n, s in
        api_t.init_cache_specs(B, S).items()}


def test_cache_len_and_window():
    cj, ct = small_configs("serve_f32")
    for w in (0, 5):
        assert (transformer.cache_len(ct.with_(window=w), 12)
                == j_T.cache_len(cj.with_(window=w), 12))
    # a sliding window keeps the last ``window`` positions, as the reference
    cj, ct = cj.with_(window=5), ct.with_(window=5)
    pj, pt = serve_params(cj, ct)
    tok = prompt(ct, seed=14)
    lj, cache_j = j_T.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    lt, cache_t = transformer.prefill(pt, {"tokens": torch.tensor(tok)}, ct)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
    assert cache_t["k"].shape[2] == 5
    assert_caches_close(cache_t, cache_j, 16)


def test_prefill_attention_takes_the_kernel_on_cuda(monkeypatch):
    """On CUDA tensors with no window the prefill's attention is the flash
    kernel's wrapper; with a window, or on the CPU, it is blockwise_attention."""
    _, ct = small_configs("serve_f32")
    calls = []

    def recorder(name):
        def attend(q, k, v, *, causal, **kw):
            calls.append((name, q.device.type, causal, kw.get("window")))
            return torch.empty_like(q)
        return attend

    monkeypatch.setattr(transformer.flash_ops, "flash_attention", recorder("flash"))
    monkeypatch.setattr(transformer.attn, "blockwise_attention", recorder("blockwise"))
    shapes = ((B, S, ct.n_heads, ct.head_dim), (B, S, ct.n_kv_heads, ct.head_dim))
    with FakeTensorMode():
        q = torch.empty(shapes[0], device="cuda")
        k = torch.empty(shapes[1], device="cuda")
        assert transformer.prefill_attention(q, k, k, ct).shape == shapes[0]
        transformer.prefill_attention(q, k, k, ct.with_(window=4))
    transformer.prefill_attention(torch.zeros(shapes[0]), torch.zeros(shapes[1]),
                                  torch.zeros(shapes[1]), ct)
    assert calls == [("flash", "cuda", True, None), ("blockwise", "cuda", True, 4),
                     ("blockwise", "cpu", True, 0)]
