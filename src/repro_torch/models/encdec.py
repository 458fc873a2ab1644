"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``, arXiv:2212.04356).

The conv audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings, "frames" (B, enc_len, d_model). LayerNorm,
GELU and sinusoidal positions (no rotary); a bidirectional encoder and a
causal decoder with cross-attention over the encoder's states. Every
prompt attention is ``transformer.train_attention`` in the training
forward and ``transformer.prefill_attention`` in the prefill, so on the
card all three (the encoder's, the decoder's causal self-attention and the
cross-attention, Sq != Sk) reach the flash kernel. Decode keeps a rolling
self-attention cache and the static cross K and V, {"k", "v", "xk", "xv"}
stacked over the decoder layers (L, B, S, Hk, Dh), as the reference does.

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules), the training forward is
tensor-parallel (``parallel/tensor.py``); every leaf it reads there splits
into units of independent work, and none is gathered. Each attention of
the encoder and of the decoder (self and cross) projects this rank's query
heads and its K and V heads column-parallel (``transformer.qkv``: the
replicated input, and for cross-attention the replicated encoder states,
one ``replicated`` for each layer's K and V products, so that the encoder
states' cotangent sums each layer's partial part once), and ``wo`` is
row-parallel; the GELU MLPs split their width; the embedding and the tied
head with its cross-entropy split the vocabulary. The norms stay whole.
Serving runs on one device, its parameters whole.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import tensor


def enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": T.attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=False),
    }


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": T.attn_specs(cfg),
        "ln_x": T.norm_specs(cfg),
        "xattn": T.attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=False),
    }


def specs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "enc_layers": [enc_layer_specs(cfg) for _ in range(cfg.n_enc_layers)],
        "enc_ln_f": T.norm_specs(cfg),
        "dec_layers": [dec_layer_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_f": T.norm_specs(cfg),
    }


def encode(params, frames, cfg: ModelConfig, serving: bool = False):
    """frames: (B, enc_len, D) stub embeddings -> encoder states. ``serving``
    (the prefill) takes the forward-only attention and no remat."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(cfg.dtype) + L.sinusoidal(positions, cfg.d_model).to(cfg.dtype)
    attention = T.prefill_attention if serving else T.train_attention

    def layer(x, lp):
        h = x + _attend(lp["attn"], T.norm(cfg, lp["ln1"], x), cfg, positions, attention,
                        causal=False)[0]
        return h + _mlp(lp, h, cfg)

    for lp in params["enc_layers"]:
        x = L.remat(cfg.remat and not serving, layer, x, lp)
    return T.norm(cfg, params["enc_ln_f"], x)


def _attend(p, x, cfg: ModelConfig, positions, attention, *, causal: bool, kv_x=None):
    """One attention without rope (self-attention, or with ``kv_x`` the
    cross-attention to it) -> (output (B, S, D), K, V). Where the query
    heads are split over "model", over this rank's heads, ``wo``
    row-parallel."""
    b, s, _ = x.shape
    group = tensor.split_group(p["wq"].shape[-1], cfg.n_heads * cfg.head_dim)
    q, k, v = T.qkv(p, x, cfg, positions, rope=False, group=group, kv_x=kv_x)
    o = attention(q, k, v, cfg, causal=causal).reshape(b, s, -1)
    return (L.matmul(o, p["wo"]) if group is None else tensor.row(o, p["wo"], group)), k, v


def _mlp(lp, h, cfg: ModelConfig):
    return L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), "gelu",
                 tensor.mlp_group(lp["mlp"], cfg.d_ff))


def _decoder(params, tokens, enc, cfg: ModelConfig, collect_cache: bool = False):
    """The decoder over the whole of ``tokens`` -> (final hidden states, and
    with ``collect_cache`` (the prefill: forward-only attention, no remat)
    each layer's (k, v, xk, xv), else None)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed(params["embed"], tokens, T.vocab_group(params, cfg)).to(cfg.dtype)
    x = x + L.sinusoidal(positions, cfg.d_model).to(cfg.dtype)
    attention = T.prefill_attention if collect_cache else T.train_attention
    caches = []

    def layer(x, lp):
        o, k, v = _attend(lp["attn"], T.norm(cfg, lp["ln1"], x), cfg, positions, attention,
                          causal=True)
        h = x + o
        ox, kx, vx = _attend(lp["xattn"], T.norm(cfg, lp["ln_x"], h), cfg, positions, attention,
                             causal=False, kv_x=enc)
        h = h + ox
        if collect_cache:
            caches.append((k, v, kx, vx))
        return h + _mlp(lp, h, cfg)

    for lp in params["dec_layers"]:
        x = L.remat(cfg.remat and not collect_cache, layer, x, lp)
    stacked = tuple(torch.stack(c) for c in zip(*caches)) if collect_cache else None
    return T.norm(cfg, params["ln_f"], x), stacked


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {"frames": (B, enc_len, D), "tokens", "labels": (B, S) int}."""
    enc = encode(params, batch["frames"], cfg)
    x, _ = _decoder(params, batch["tokens"], enc, cfg)
    group = T.vocab_group(params, cfg)
    return L.softmax_xent(L.lm_logits(params["embed"], x, cfg.vocab, group), batch["labels"],
                          group=group)


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    s = T.cache_len(cfg, seq_len)
    kv = ParamSpec((cfg.n_layers, batch, s, hk, dh),
                   ("layers", None, None, "kv_heads", None), "zeros", cfg.dtype)
    xkv = ParamSpec((cfg.n_layers, batch, cfg.enc_len, hk, dh),
                    ("layers", None, None, "kv_heads", None), "zeros", cfg.dtype)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def prefill(params, batch, cfg: ModelConfig):
    """batch: {"frames": (B, enc_len, D), "tokens": (B, S)} -> (last-position
    logits (B, 1, V), cache {"k", "v"}: (L, B, S, Hk, Dh) and {"xk", "xv"}:
    (L, B, enc_len, Hk, Dh))."""
    enc = encode(params, batch["frames"], cfg, serving=True)
    x, (k, v, kx, vx) = _decoder(params, batch["tokens"], enc, cfg, collect_cache=True)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    return logits, {"k": k, "v": v, "xk": kx, "xv": vx}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions; the
    self-attention cache is written at ``pos % S``, and the cross-attention
    reads all enc_len encoder positions."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    x = x + L.sinusoidal(pos[:, None], cfg.d_model).to(cfg.dtype)
    bidx = torch.arange(b, device=tokens.device)
    s_cache = cache["k"].shape[2]
    widx = (pos % s_cache).long()
    n_valid = torch.clamp(pos + 1, max=s_cache)
    n_enc = torch.full((b,), cache["xk"].shape[2], device=tokens.device)
    ks, vs = [], []
    for i, lp in enumerate(params["dec_layers"]):
        kx, vx = cache["xk"][i], cache["xv"][i]
        xn = T.norm(cfg, lp["ln1"], x)
        q, k, v = T.qkv(lp["attn"], xn, cfg, pos[:, None], rope=False)
        kc = cache["k"][i].index_put((bidx, widx), k[:, 0].to(cache["k"].dtype))
        vc = cache["v"][i].index_put((bidx, widx), v[:, 0].to(cache["v"].dtype))
        o = attn.decode_attention(q, kc, vc, n_valid)
        h = x + L.matmul(o.reshape(b, 1, -1), lp["attn"]["wo"])
        hn = T.norm(cfg, lp["ln_x"], h)
        qx = L.matmul(hn, lp["xattn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        ox = attn.decode_attention(qx, kx, vx, n_enc)
        h = h + L.matmul(ox.reshape(b, 1, -1), lp["xattn"]["wo"])
        x = h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), "gelu")
        ks.append(kc)
        vs.append(vc)
    x = T.norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x, cfg.vocab)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "xk": cache["xk"],
                    "xv": cache["xv"]}
