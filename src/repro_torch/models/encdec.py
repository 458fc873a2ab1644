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
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec


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
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device)
    x = frames.to(cfg.dtype) + L.sinusoidal(positions, cfg.d_model).to(cfg.dtype)
    attention = T.prefill_attention if serving else T.train_attention

    def layer(x, lp):
        xn = T.norm(cfg, lp["ln1"], x)
        q, k, v = T.qkv(lp["attn"], xn, cfg, positions, rope=False)
        o = attention(q, k, v, cfg, causal=False)
        h = x + L.matmul(o.reshape(b, s, -1), lp["attn"]["wo"])
        return h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), "gelu")

    for lp in params["enc_layers"]:
        x = L.remat(cfg.remat and not serving, layer, x, lp)
    return T.norm(cfg, params["enc_ln_f"], x)


def _cross_kv(lp, enc, cfg: ModelConfig):
    b, se, _ = enc.shape
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    k = L.matmul(enc, lp["xattn"]["wk"]).reshape(b, se, hk, dh)
    v = L.matmul(enc, lp["xattn"]["wv"]).reshape(b, se, hk, dh)
    return k, v


def _decoder(params, tokens, enc, cfg: ModelConfig, collect_cache: bool = False):
    """The decoder over the whole of ``tokens`` -> (final hidden states, and
    with ``collect_cache`` (the prefill: forward-only attention, no remat)
    each layer's (k, v, xk, xv), else None)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    x = x + L.sinusoidal(positions, cfg.d_model).to(cfg.dtype)
    attention = T.prefill_attention if collect_cache else T.train_attention
    caches = []

    def layer(x, lp):
        xn = T.norm(cfg, lp["ln1"], x)
        q, k, v = T.qkv(lp["attn"], xn, cfg, positions, rope=False)
        o = attention(q, k, v, cfg, causal=True)
        h = x + L.matmul(o.reshape(b, s, -1), lp["attn"]["wo"])
        hn = T.norm(cfg, lp["ln_x"], h)  # cross-attention
        qx = L.matmul(hn, lp["xattn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
        kx, vx = _cross_kv(lp, enc, cfg)
        ox = attention(qx, kx, vx, cfg, causal=False)
        h = h + L.matmul(ox.reshape(b, s, -1), lp["xattn"]["wo"])
        if collect_cache:
            caches.append((k, v, kx, vx))
        return h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), "gelu")

    for lp in params["dec_layers"]:
        x = L.remat(cfg.remat and not collect_cache, layer, x, lp)
    stacked = tuple(torch.stack(c) for c in zip(*caches)) if collect_cache else None
    return T.norm(cfg, params["ln_f"], x), stacked


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {"frames": (B, enc_len, D), "tokens", "labels": (B, S) int}."""
    enc = encode(params, batch["frames"], cfg)
    x, _ = _decoder(params, batch["tokens"], enc, cfg)
    return L.softmax_xent(L.lm_logits(params["embed"], x, cfg.vocab), batch["labels"])


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
