"""Dense decoder-only transformer family (llama-arch), decode path.

Counterpart of ``repro.models.transformer``: parameter specs, ``norm``,
``qkv`` and the single-token ``decode_step`` over a dense f32/bf16 KV cache
(the ``kv_bits == 16`` path that the serve loop's dense reference reaches).
Layers are a Python list of per-layer parameter dicts instead of a stacked
axis scanned by ``lax.scan``; the KV cache keeps the reference's stacked
(L, B, S, Hk, Dh) layout.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.base import ParamSpec


def norm_specs(cfg: ModelConfig):
    return L.rmsnorm_specs(cfg.d_model) if cfg.norm == "rmsnorm" else L.layernorm_specs(cfg.d_model)


def norm(cfg: ModelConfig, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * dh), ("embed", "heads"), "scaled"),
        "wk": ParamSpec((d, hk * dh), ("embed", "kv_heads"), "scaled"),
        "wv": ParamSpec((d, hk * dh), ("embed", "kv_heads"), "scaled"),
        "wo": ParamSpec((h * dh, d), ("heads", "embed"), "scaled"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h * dh,), ("heads",), "zeros")
        s["bk"] = ParamSpec((hk * dh,), ("kv_heads",), "zeros")
        s["bv"] = ParamSpec((hk * dh,), ("kv_heads",), "zeros")
    return s


def qkv(p, x, cfg: ModelConfig, positions, rope: bool = True):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(w, bias):
        y = L.matmul(x, p[w])
        return y + p[bias] if bias in p else y

    q = proj("wq", "bq").reshape(b, s, h, dh)
    k = proj("wk", "bk").reshape(b, s, hk, dh)
    v = proj("wv", "bv").reshape(b, s, hk, dh)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": norm_specs(cfg),
        "attn": attn_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=cfg.act == "silu"),
    }


def specs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "layers": [layer_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_f": norm_specs(cfg),
    }


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions.

    ``cache`` is {"k", "v"}: (L, B, S, Hk, Dh). The write index is
    ``pos % S`` (rolling buffer). Returns (logits (B, 1, V), new cache).

    The embedding is cast to ``cfg.dtype``; with bf16 and f32 parameters the
    residual stream is bf16 only until the first residual add, and f32 after
    it. (The reference's ``lax.scan`` refuses that dtype change of its carry,
    so at bf16 the reference is the unrolled loop; see ROADMAP.md.)
    """
    if cfg.kv_bits != 16:
        raise NotImplementedError("kv_bits < 16 decode is not ported yet (ROADMAP.md, queue 1)")
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    s_cache = cache["k"].shape[2]
    widx = (pos % s_cache).long()
    bidx = torch.arange(b, device=tokens.device)
    cache_len = torch.clamp(pos + 1, max=s_cache)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        xn = norm(cfg, lp["ln1"], x)
        q, k, v = qkv(lp["attn"], xn, cfg, pos[:, None])
        kc = cache["k"][i].index_put((bidx, widx), k[:, 0].to(cache["k"].dtype))
        vc = cache["v"][i].index_put((bidx, widx), v[:, 0].to(cache["v"].dtype))
        o = attn.decode_attention(q, kc, vc, cache_len)
        h = x + L.matmul(o.reshape(b, 1, -1), lp["attn"]["wo"])
        x = h + L.mlp(lp["mlp"], norm(cfg, lp["ln2"], h), cfg.act)
        ks.append(kc)
        vs.append(vc)
    x = norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x, cfg.vocab)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
