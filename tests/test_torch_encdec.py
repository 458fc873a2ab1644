"""Parity of the port's encoder-decoder family (``repro_torch.models.encdec``,
the registry's ``encdec``, and ``layers.sinusoidal``) with the JAX
package's ``repro.models.encdec``, on the CPU, where every attention is the
plain blockwise attention as in the reference.

Inputs: whisper-medium's smoke variant (2 encoder and 4 decoder layers,
d_model 128, 4 heads of 32, ``enc_len`` 32, so the reference's blockwise
attention pads nothing), parameters from the reference's ``materialize``,
frames and tokens from numpy seeds.

At whisper's published ``enc_len`` of 1500 the reference's
``blockwise_attention`` (blocks of 1024) pads the keys to 2048 and masks
from ``Sk - pad`` = 952, so every encoder self-attention and every prefill
cross-attention drops frames 952-1499 (its decode's cross-attention sees
all 1500). The port computes the function without that fault: its encoder
equals the reference's run with ``reference_attention`` in place of the
blockwise attention, patched in the test only.

Tolerances: sinusoidal 1e-5 relative plus 2e-6 absolute (f32 sin and cos of
angles up to 1500 rad in two libraries; measured 6e-8). The rest as
tests/torch_family_parity.py (f32: 1e-5 x a leaf's largest |value| plus
1e-5 relative; measured <= 1.5e-6 of the largest); the bf16 loss within
2e-3 relative, as tests/test_torch_moe.py. ``dtype`` bf16 with f32
parameters, which the reference's layer scans refuse (their carry turns
from bf16 into f32), is held against the layer bodies unrolled in JAX, at
the f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_medium as j_whisper
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import attention as j_attn
from repro.models import encdec as j_encdec
from repro.models import layers as j_L
from repro.models import registry as j_registry
from repro.models import transformer as j_T
from repro_torch.configs import whisper_medium
from repro_torch.configs.base import smoke_variant
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as attn
from repro_torch.models import encdec, layers, registry
from repro_torch.models import transformer as T
from test_torch_parity import to_np
from torch_family_parity import (TOL, batch_np, check_bf16_dtype_with_f32_params,
                                 check_loss_and_grads, check_prefill_then_decode,
                                 check_specs_and_round_trip, layer_params, params_pair, to_jax,
                                 to_torch)


def configs(**kw):
    return (j_smoke_variant(j_whisper.CONFIG).with_(**kw),
            smoke_variant(whisper_medium.CONFIG).with_(**kw))


@pytest.mark.parametrize("d", [128, 1024, 7])
def test_sinusoidal_matches_reference(d):
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(j_L.sinusoidal(jnp.asarray(pos), d))
    got = to_np(layers.sinusoidal(torch.from_numpy(pos), d))
    assert got.shape == want.shape == (1500, 2 * (d // 2)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=2e-6)
    # a decode step's (B, 1) positions
    p2 = np.array([[3], [1499]], np.int32)
    np.testing.assert_allclose(to_np(layers.sinusoidal(torch.from_numpy(p2), d)),
                               np.asarray(j_L.sinusoidal(jnp.asarray(p2), d)), rtol=TOL,
                               atol=2e-6)


def test_encode_matches_reference():
    cj, ct = configs()
    pj, pt = params_pair(cj, ct)
    frames = batch_np(ct)["frames"]
    want = np.asarray(j_encdec.encode(pj, jnp.asarray(frames), cj))
    got = to_np(encdec.encode(pt, torch.from_numpy(frames), ct))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    cj, ct = configs(remat=remat)
    check_loss_and_grads(cj, ct, batch_np(ct))


def test_bf16_loss_matches_reference():
    cj, ct = configs(dtype=jnp.bfloat16)
    ct = ct.with_(dtype=torch.bfloat16)
    pj, pt = params_pair(cj, ct, dtype=None)
    batch = batch_np(ct)
    lj = j_registry.get_api(cj).loss_fn(pj, to_jax(batch))
    lt = registry.get_api(ct).loss_fn(pt, to_torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)


def test_prefill_then_decode_matches_reference():
    """Prefill over 32 frames and 2 x 12 tokens, then 4 greedy decode steps
    from the self-attention cache lengthened by 4 zero positions (the cross
    K and V as the prefill left them): logits and "k", "v", "xk", "xv"."""
    cj, ct = configs()
    check_prefill_then_decode(cj, ct, batch_np(ct, s=12, labels=False), pad=("k", "v"))


def test_specs_and_convert_round_trip():
    """``enc_layers`` and ``dec_layers`` stacked in the reference and listed
    in the port."""
    check_specs_and_round_trip(*configs())


def test_cuda_tensors_reach_the_kernel_with_the_right_mask(monkeypatch):
    """On CUDA tensors every prompt attention of whisper is the flash
    kernel's: the prefill's through the forward-only entry, the training
    forward's through the autograd entry, the encoder's and the
    cross-attention's (Sq != Sk) without the causal mask, the decoder's
    self-attention with it; a decode step asks for none. Device types are
    faked for the routing (the choice is by type); the model runs on the CPU
    with its two attention entries recorded."""
    _, ct = configs()
    routed = []

    def stand_in(name):
        return lambda q, k, v, *, causal, **kw: routed.append((name, causal)) or q

    with monkeypatch.context() as m:
        m.setattr(flash_ops, "flash_attention", stand_in("kernel"))
        m.setattr(flash_ops, "flash_attention_train", stand_in("kernel_autograd"))
        m.setattr(attn, "blockwise_attention", stand_in("blockwise"))

        class Fake:
            device = torch.device("cuda")

        for causal in (True, False):
            for entry in (T.prefill_attention, T.train_attention):
                entry(Fake(), None, None, ct, causal=causal)
                entry(torch.zeros(1), None, None, ct, causal=causal)
    assert routed == [(name, causal) for causal in (True, False)
                      for name in ("kernel", "blockwise", "kernel_autograd", "blockwise")]

    asked = []

    def recorded(name, fn):
        def entry(q, k, v, cfg, *, causal=True):
            asked.append((name, causal, q.shape[1], k.shape[1]))
            return fn(q, k, v, cfg, causal=causal)
        return entry

    monkeypatch.setattr(T, "prefill_attention", recorded("prefill", T.prefill_attention))
    monkeypatch.setattr(T, "train_attention", recorded("train", T.train_attention))
    _, pt = params_pair(*configs())
    batch = to_torch(batch_np(ct, s=12))
    api = registry.get_api(ct)
    _, cache = api.prefill(pt, {k: batch[k] for k in ("tokens", "frames")})
    n_prefill = len(asked)
    api.decode_step(pt, cache, batch["tokens"][:, :1], torch.full((2,), 12, dtype=torch.int32))
    assert len(asked) == n_prefill
    api.loss_fn(pt, batch)
    se = ct.enc_len
    per = [(False, se, se)] * ct.n_enc_layers + [(True, 12, 12), (False, 12, se)] * ct.n_layers
    assert asked == [("prefill", *c) for c in per] + [("train", *c) for c in per]


def test_reference_drops_padded_encoder_frames_and_the_port_does_not(monkeypatch):
    """2 encoder layers at the smoke width with whisper's 1500 frames: the
    port's ``encode`` equals the reference's with its exact
    ``reference_attention`` in place of the blockwise attention; the
    reference as it is equals the same with keys 952-1499 dropped, and
    differs from the exact function by more than 1e-2."""
    cj, ct = configs(enc_len=1500)
    pj, pt = params_pair(cj, ct)
    frames = np.random.default_rng(9).standard_normal((1, 1500, ct.d_model)).astype(np.float32)
    faulty = np.asarray(j_encdec.encode(pj, jnp.asarray(frames), cj))

    def exact(q, k, v, *, causal, **kw):
        return j_attn.reference_attention(q, k, v, causal=causal, **kw)

    def first_952(q, k, v, *, causal, **kw):
        return j_attn.reference_attention(q, k[:, :952], v[:, :952], causal=causal, **kw)

    with monkeypatch.context() as m:
        m.setattr(j_attn, "blockwise_attention", exact)
        want = np.asarray(j_encdec.encode(pj, jnp.asarray(frames), cj))
        m.setattr(j_attn, "blockwise_attention", first_952)
        dropped = np.asarray(j_encdec.encode(pj, jnp.asarray(frames), cj))
    got = to_np(encdec.encode(pt, torch.from_numpy(frames), ct))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    np.testing.assert_allclose(faulty, dropped, rtol=TOL, atol=TOL * scale)
    assert float(np.abs(faulty - want).max()) > 1e-2


def j_prefill_unrolled(params, batch, cfg):
    """The reference's ``prefill`` (``encode``, then ``_decoder`` collecting
    the caches) with both layer scans as Python loops."""
    frames, tokens = batch["frames"], batch["tokens"]
    se = frames.shape[1]
    pos_e = jnp.arange(se)
    x = frames.astype(cfg.dtype) + j_L.sinusoidal(pos_e, cfg.d_model).astype(cfg.dtype)
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params["enc_layers"], i)
        q, k, v = j_T.qkv(lp["attn"], j_T.norm(cfg, lp["ln1"], x), cfg, pos_e, rope=False)
        o = j_attn.blockwise_attention(q, k, v, causal=False)
        x = x + o.reshape(x.shape[0], se, -1) @ lp["attn"]["wo"]
        x = x + j_L.mlp(lp["mlp"], j_T.norm(cfg, lp["ln2"], x), "gelu")
    enc = j_T.norm(cfg, params["enc_ln_f"], x)
    b, s = tokens.shape
    pos = jnp.arange(s)
    x = j_L.embed(params["embed"], tokens).astype(cfg.dtype)
    x = x + j_L.sinusoidal(pos, cfg.d_model).astype(cfg.dtype)
    caches = []
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        q, k, v = j_T.qkv(lp["attn"], j_T.norm(cfg, lp["ln1"], x), cfg, pos, rope=False)
        o = j_attn.blockwise_attention(q, k, v, causal=True)
        h = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        qx = (j_T.norm(cfg, lp["ln_x"], h) @ lp["xattn"]["wq"]).reshape(b, s, cfg.n_heads,
                                                                      cfg.head_dim)
        kx, vx = j_encdec._cross_kv(lp, enc, cfg)
        ox = j_attn.blockwise_attention(qx, kx, vx, causal=False)
        h = h + ox.reshape(b, s, -1) @ lp["xattn"]["wo"]
        x = h + j_L.mlp(lp["mlp"], j_T.norm(cfg, lp["ln2"], h), "gelu")
        caches.append((k, v, kx, vx))
    x = j_T.norm(cfg, params["ln_f"], x)
    cache = dict(zip(("k", "v", "xk", "xv"), (jnp.stack(c) for c in zip(*caches))))
    return j_L.lm_logits(params["embed"], x[:, -1:], cfg.vocab), cache


def test_bf16_dtype_with_f32_params_matches_unrolled_reference():
    cj, ct = configs()
    check_bf16_dtype_with_f32_params(cj, ct, batch_np(ct, s=12, labels=False),
                                     j_prefill_unrolled)
