"""Mixture-of-Experts transformers: granite-moe (top-8 of 40, GQA) and
deepseek-v3 (MLA + 1 shared + 256 routed top-8 + dense-first layers + MTP)
(counterpart of ``repro.models.moe``).

Dispatch is sort-based with capacity (MegaBlocks-style dense buffers):
assignments are stably sorted by expert, placed into an (E, C, D) buffer
(capacity drop: an expert keeps its first C assignments in token order),
run through the experts as batched products, and combined by router
weight. The reference's expert-parallel dispatch (``moe_apply_ep``, a
``shard_map`` over a mesh) is the multi-card slice's (ROADMAP.md, queue 1);
on one card ``_moe_ffn`` is ``moe_apply``, as the reference's is without a
mesh. With ``cfg.mla`` each layer's attention is ``models/mla.py``'s, and
the cache holds its latents (c_kv, k_rope) in place of K and V.

Layers are Python lists (``moe_layers``, ``dense_layers``) where the
reference stacks them for ``lax.scan``; the KV cache keeps its stacked
(L, B, S, Hk, Dh) layout (MLA's: (L, B, S, KL) and (L, B, S, DR)).
Attention is ``transformer.train_attention`` in the training forward and
``transformer.prefill_attention`` in the prefill, so both reach the flash
kernel on the card; ``decode_step`` keeps the dense ``decode_attention``
(MLA: the absorbed ``mla_decode``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((d, e), ("embed", None), "scaled", torch.float32),
        "w_in": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), "scaled"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), "scaled"),
        "w_out": ParamSpec((e, f, d), ("experts", "moe_ff", "embed"), "scaled"),
    }
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_specs(d, cfg.moe_d_ff * cfg.n_shared_experts)
    return s


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-c // 8) * 8  # pad for tiling


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (out, aux_loss).

    Ties follow the reference: ``ops.top_k`` picks the lower expert on equal
    probabilities, and the stable sort keeps each expert's assignments in
    token order, so the capacity drop removes exactly the reference's. No
    step reads a value back to the host (``capacity`` comes from the shapes).
    """
    b, s, d = x.shape
    n = b * s
    k = cfg.top_k
    e = cfg.n_experts
    xf = x.reshape(n, d)

    logits = L.matmul(xf.float(), p["router"]).float()
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    w, idx = ops.top_k(probs, k)  # (N, K)
    w = w / w.sum(-1, keepdim=True)

    # Switch-style load-balance auxiliary loss (a fixed-order sum, no atomics).
    me = probs.mean(0)
    ce = ops.segment_sum(w.reshape(-1), idx.reshape(-1), e) / n
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)

    # ---- sort-based dispatch with capacity ----
    # Kept in (token, k) order: an assignment's rank among its expert's is
    # found by the stable sort and carried back, so that each token's row goes
    # to its K slots as one broadcast (whose gradient is a sum over K, where
    # a gather of the row K times would scatter-add it back).
    cap = capacity(cfg, n)
    flat_e = idx.reshape(-1).long()  # (N*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(n * k, device=x.device) - seg_start[sorted_e])
    slot = torch.where(pos < cap, flat_e * cap + pos, e * cap).reshape(n, k)  # e*cap: dropped

    buf = ops.at_set(x.new_zeros((e * cap, d)), slot, xf[:, None])
    hb = buf.reshape(e, cap, d)
    h = L.matmul(hb, p["w_in"])
    g = L.matmul(hb, p["w_gate"])
    h = (h * F.silu(g)).to(x.dtype)
    yb = L.matmul(h, p["w_out"]).reshape(e * cap, d)

    # ---- combine ----
    # The reference scatter-adds each token's K contributions in sorted
    # (expert-id) order. Here each token's K slots are put in that order, their
    # rows gathered, and summed in it: the same additions, with no atomics.
    by_expert = torch.argsort(idx, dim=-1, stable=True)
    slot = torch.gather(slot, 1, by_expert).reshape(-1)
    w_e = torch.gather(w, 1, by_expert)
    rows = torch.gather(yb, 0, torch.clamp(slot, max=e * cap - 1)[:, None].expand(n * k, d))
    per_assign = torch.where((slot < e * cap)[:, None], rows, 0).reshape(n, k, d)
    contrib = per_assign.float() * w_e[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], xf, cfg.act).float()
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_ffn(cfg: ModelConfig, p, xn):
    """The reference picks its expert-parallel ``shard_map`` dispatch here
    under a mesh with a model axis; one card has none, so this is
    ``moe_apply``."""
    return moe_apply(p, xn, cfg)


# ---------------------------------------------------------------------------
# Full MoE decoder model (granite; deepseek-v3's dense-first layers, shared
# experts and MTP)
# ---------------------------------------------------------------------------
def _attn_specs(cfg: ModelConfig):
    return mla_mod.mla_specs(cfg) if cfg.mla else T.attn_specs(cfg)


def _attn_apply(cfg: ModelConfig, p, xn, positions):
    """Causal self-attention of a training forward (the flash kernel's
    autograd entry on the card)."""
    if cfg.mla:
        return mla_mod.mla_attention(p, xn, cfg, positions)
    return T.attn_block(p, xn, cfg, positions)


def moe_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "moe": moe_specs(cfg),
    }


def dense_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=True),
    }


def specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "moe_layers": [moe_layer_specs(cfg) for _ in range(cfg.n_layers - cfg.first_k_dense)],
        "ln_f": T.norm_specs(cfg),
    }
    if cfg.first_k_dense:
        s["dense_layers"] = [dense_layer_specs(cfg) for _ in range(cfg.first_k_dense)]
    if cfg.mtp_depth:
        s["mtp"] = {
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("embed", "embed"), "scaled"),
            "block": dense_layer_specs(cfg),
            "ln": T.norm_specs(cfg),
        }
    return s


def _dense_layer(cfg: ModelConfig, lp, x, positions):
    h = x + _attn_apply(cfg, lp["attn"], T.norm(cfg, lp["ln1"], x), positions)
    return h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), cfg.act)


def forward(params, batch, cfg: ModelConfig):
    """Returns (hidden (B, S, D), aux_loss)."""
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def dense_body(x, lp):
        return _dense_layer(cfg, lp, x, positions)

    def moe_body(x, aux, lp):
        h = x + _attn_apply(cfg, lp["attn"], T.norm(cfg, lp["ln1"], x), positions)
        y, a = _moe_ffn(cfg, lp["moe"], T.norm(cfg, lp["ln2"], h))
        return h + y, aux + a

    for lp in params.get("dense_layers", ()):
        x = L.remat(cfg.remat, dense_body, x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["moe_layers"]:
        x, aux = L.remat(cfg.remat, moe_body, x, aux, lp)
    return T.norm(cfg, params["ln_f"], x), aux


def loss_fn(params, batch, cfg: ModelConfig):
    x, aux = forward(params, batch, cfg)
    logits = L.lm_logits(params["embed"], x, cfg.vocab)
    loss = L.softmax_xent(logits, batch["labels"])
    if cfg.mtp_depth:
        # DeepSeek-V3 MTP (depth 1): predict token t+2 from [h_t ; emb(t+1)].
        nxt = batch["labels"]  # token at t+1
        emb_next = L.embed(params["embed"], torch.clamp(nxt, min=0)).to(cfg.dtype)
        dt = torch.promote_types(x.dtype, emb_next.dtype)
        h2 = L.matmul(torch.cat([x.to(dt), emb_next.to(dt)], dim=-1), params["mtp"]["proj"])
        h2 = _dense_layer(cfg, params["mtp"]["block"], h2,
                          torch.arange(x.shape[1], device=x.device))
        h2 = T.norm(cfg, params["mtp"]["ln"], h2)
        logits2 = L.lm_logits(params["embed"], h2[:, :-1], cfg.vocab)
        mtp_labels = batch["labels"][:, 1:]  # token at t+2
        loss = loss + cfg.mtp_loss_coef * L.softmax_xent(logits2, mtp_labels)
    return loss + aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
# the layer groups in the order they run, each with its cache keys' prefix
GROUPS = (("dense", "dense_layers"), ("moe", "moe_layers"))


def _cache_names(cfg: ModelConfig):
    """The two cache tensors of a layer group, after its prefix: MLA's
    latents, or K and V."""
    return ("ckv", "krope") if cfg.mla else ("k", "v")


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """{"moe_k", "moe_v"} (and "dense_k", "dense_v"): (L, B, S, Hk, Dh); with
    MLA {"moe_ckv", "moe_krope"} (and "dense_ckv", "dense_krope"): (L, B, S,
    KL) and (L, B, S, DR)."""
    s = T.cache_len(cfg, seq_len)
    if cfg.mla:
        tails = ((cfg.kv_lora_rank,), (cfg.rope_head_dim,))
        axes = (None,)
    else:
        tails = ((cfg.n_kv_heads, cfg.head_dim),) * 2
        axes = ("kv_heads", None)
    out = {}
    for prefix, n in (("moe", cfg.n_layers - cfg.first_k_dense), ("dense", cfg.first_k_dense)):
        if prefix == "moe" or n:
            for name, tail in zip(_cache_names(cfg), tails):
                out[f"{prefix}_{name}"] = ParamSpec((n, batch, s, *tail),
                                                    ("layers", None, None, *axes), "zeros",
                                                    cfg.dtype)
    return out


def _serve_ffn(cfg: ModelConfig, lp, h):
    """A layer's feed-forward block in a serving pass: the dense-first
    layers' MLP, or the experts (whose aux loss serving drops)."""
    hn = T.norm(cfg, lp["ln2"], h)
    return h + (L.mlp(lp["mlp"], hn, cfg.act) if "mlp" in lp else moe_apply(lp["moe"], hn, cfg)[0])


def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence pass that also materializes the KV cache.

    batch: {"tokens": (B, S) int}. Returns (last-position logits (B, 1, V),
    cache {"moe_k", "moe_v"} (and "dense_k", "dense_v"), each (L, B, S, Hk,
    Dh); with MLA {"moe_ckv", "moe_krope"} (and "dense_ckv",
    "dense_krope"), (L, B, S, KL) and (L, B, S, DR); exactly
    ``cache_len(cfg, S)`` long).
    """
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)

    def attend(lp, x):
        xn = T.norm(cfg, lp["ln1"], x)
        if cfg.mla:
            o, (ckv, krope) = mla_mod.mla_attention(lp["attn"], xn, cfg, positions,
                                                    return_cache=True,
                                                    attention=T.prefill_attention)
            return x + o, ckv, krope
        q, k, v = T.qkv(lp["attn"], xn, cfg, positions)
        o = T.prefill_attention(q, k, v, cfg)
        return x + L.matmul(o.reshape(b, s, -1), lp["attn"]["wo"]), k, v

    n1, n2 = _cache_names(cfg)
    cache = {}
    for prefix, key in GROUPS:
        if key not in params:
            continue
        c1s, c2s = [], []
        for lp in params[key]:
            h, c1, c2 = attend(lp, x)
            x = _serve_ffn(cfg, lp, h)
            c1s.append(c1)
            c2s.append(c2)
        cache[f"{prefix}_{n1}"], cache[f"{prefix}_{n2}"] = torch.stack(c1s), torch.stack(c2s)
    x = T.norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    w = T.cache_len(cfg, s)
    return logits, {k: v[:, :, -w:] for k, v in cache.items()}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions; the
    write index is ``pos % S`` (rolling buffer). Returns (logits (B, 1, V),
    new cache)."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    bidx = torch.arange(b, device=tokens.device)

    def attn_decode(lp, x, c1, c2):
        xn = T.norm(cfg, lp["ln1"], x)
        if cfg.mla:
            o, c1, c2 = mla_mod.mla_decode(lp["attn"], xn, cfg, pos, c1, c2)
            return x + o, c1, c2
        s_cache = c1.shape[1]
        widx = (pos % s_cache).long()
        q, k, v = T.qkv(lp["attn"], xn, cfg, pos[:, None])
        c1 = c1.index_put((bidx, widx), k[:, 0].to(c1.dtype))
        c2 = c2.index_put((bidx, widx), v[:, 0].to(c2.dtype))
        o = attn.decode_attention(q, c1, c2, torch.clamp(pos + 1, max=s_cache))
        return x + L.matmul(o.reshape(b, 1, -1), lp["attn"]["wo"]), c1, c2

    n1, n2 = _cache_names(cfg)
    new_cache = dict(cache)
    for prefix, key in GROUPS:
        if key not in params:
            continue
        c1s, c2s = [], []
        for i, lp in enumerate(params[key]):
            h, c1, c2 = attn_decode(lp, x, cache[f"{prefix}_{n1}"][i],
                                    cache[f"{prefix}_{n2}"][i])
            x = _serve_ffn(cfg, lp, h)
            c1s.append(c1)
            c2s.append(c2)
        new_cache[f"{prefix}_{n1}"], new_cache[f"{prefix}_{n2}"] = (torch.stack(c1s),
                                                                    torch.stack(c2s))
    x = T.norm(cfg, params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg.vocab), new_cache
