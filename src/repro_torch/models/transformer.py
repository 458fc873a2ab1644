"""Dense decoder-only transformer family (llama-arch): training and serving.

Counterpart of ``repro.models.transformer``: parameter specs, ``norm``,
``qkv``, the training ``forward`` and ``loss_fn`` (whose causal attention is
the hand-written flash kernel inside an autograd function on the card),
``prefill`` (the same kernel, forward only) and the single-token
``decode_step`` over a dense KV cache, f32 or bf16 (``kv_bits`` 16) or int8 /
packed int4 codes with per-token scales (``kv_bits`` 8 / 4, the RARO dense
tier). Layers are a Python list of per-layer parameter dicts instead of a
stacked axis scanned by ``lax.scan``; the KV cache keeps the reference's
stacked (L, B, S, Hk, Dh) layout. ``family == "vlm"`` prepends precomputed
image embeddings to the sequence, as the reference's internvl2 backbone does.

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules, ``parallel/sharding.py``), the training
forward is tensor-parallel (``parallel/tensor.py``): each rank computes its
query heads, its block of the MLP width and its block of the vocabulary,
and the row-parallel products sum the ranks' parts. Whole parameters take
the one-device path.
"""

from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kvcache import quant
from repro_torch.models import attention as attn
from repro_torch.models import base
from repro_torch.models import layers as L
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import collectives as C
from repro_torch.parallel import tensor


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


def qkv(p, x, cfg: ModelConfig, positions, rope: bool = True, group=None, kv_x=None):
    """Queries, keys and values (B, S, heads, Dh), the head counts read off
    the weights' shapes; with ``kv_x`` (cross-attention: whisper's encoder
    states, no rope) the keys and values are ``kv_x``'s, (B, Sk, heads, Dh).
    With ``group`` (the query heads split over "model") they are this rank's
    heads, from the replicated ``x`` (and ``kv_x``: one ``replicated`` each).
    Where the KV heads stay whole (their count does not divide the model
    axis), every rank projects them all and keeps those its queries read
    (``tensor.kv_heads_for``); the whole weights' cotangents are then partial
    on each rank, and ``replicated`` sums them."""
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    dh = cfg.head_dim
    h, hk = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    kv_whole = group is not None and hk == cfg.n_kv_heads

    def param(name):
        return C.replicated(p[name], group) if kv_whole and name not in ("wq", "bq") else p[name]

    ws = [param(w) for w in ("wq", "wk", "wv")]
    if group is None:
        ys = [L.matmul(x, ws[0])] + [L.matmul(src, w) for w in ws[1:]]
    elif kv_x is None:
        ys = tensor.column(x, ws, group)
    else:
        ys = tensor.column(x, ws[:1], group) + tensor.column(kv_x, ws[1:], group)
    ys = [y + param(bias) if bias in p else y for y, bias in zip(ys, ("bq", "bk", "bv"))]
    q = ys[0].reshape(b, s, h, dh)
    k = ys[1].reshape(b, sk, hk, dh)
    v = ys[2].reshape(b, sk, hk, dh)
    if kv_whole:
        sel = tensor.kv_heads_for(group, h, cfg.n_heads, cfg.n_kv_heads)
        if isinstance(sel, tuple):
            k, v = k[:, :, sel[0]:sel[0] + sel[1]], v[:, :, sel[0]:sel[0] + sel[1]]
        else:  # one KV head for each local query head
            k, v = k.index_select(2, sel.to(k.device)), v.index_select(2, sel.to(v.device))
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def train_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True):
    """Attention of a training forward (causal unless told otherwise): on the
    card, with no window, the flash kernel through its autograd entry (whose
    backward is the flash backward kernels), and on the meta device its
    stand-in; else the plain blockwise attention, as the reference computes
    it (the CPU, and sliding windows)."""
    if cfg.window == 0 and q.device.type != "cpu":
        return flash_ops.flash_attention_train(q, k, v, causal=causal)
    return attn.blockwise_attention(q, k, v, causal=causal, window=cfg.window)


def attn_block(p, x, cfg: ModelConfig, positions):
    """Self-attention of a training forward; where the query heads are split
    over "model", over this rank's heads, ``wo`` row-parallel."""
    b, s, _ = x.shape
    group = tensor.split_group(p["wq"].shape[-1], cfg.n_heads * cfg.head_dim)
    q, k, v = qkv(p, x, cfg, positions, group=group)
    o = train_attention(q, k, v, cfg).reshape(b, s, -1)
    return L.matmul(o, p["wo"]) if group is None else tensor.row(o, p["wo"], group)


def stack_specs(n: int, tree):
    """Prepend a stacked ``layers`` axis of ``n`` to every ParamSpec of
    ``tree`` (the layout of the recurrent families' state caches)."""
    return base.tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                                             s.dtype), tree)


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


def vocab_group(params, cfg: ModelConfig):
    """The "model" group where the embedding table's rows are split, else None."""
    return tensor.split_group(params["embed"]["table"].shape[0], L.padded_vocab(cfg.vocab))


def _embed_inputs(params, batch, cfg: ModelConfig):
    x = L.embed(params["embed"], batch["tokens"], vocab_group(params, cfg)).to(cfg.dtype)
    if cfg.family == "vlm" and "img_embeds" in batch:
        x = torch.cat([batch["img_embeds"].to(cfg.dtype), x], dim=1)
    return x


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> final hidden states (B, S, D). With
    ``cfg.remat`` each layer keeps only its input and recomputes the rest in
    the backward (``checkpoint``, where the reference has ``jax.checkpoint``)."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, lp):
        h = x + attn_block(lp["attn"], norm(cfg, lp["ln1"], x), cfg, positions)
        return h + L.mlp(lp["mlp"], norm(cfg, lp["ln2"], h), cfg.act,
                         tensor.mlp_group(lp["mlp"], cfg.d_ff))

    for lp in params["layers"]:
        x = L.remat(cfg.remat, layer, x, lp)
    return norm(cfg, params["ln_f"], x)


def loss_fn(params, batch, cfg: ModelConfig):
    """Token-mean next-token cross entropy of ``batch`` ({"tokens", "labels"}:
    (B, S) int; for ``vlm``, "img_embeds": (B, N, D), whose positions carry no
    label), through the tied embedding head."""
    x = forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.family == "vlm" and "img_embeds" in batch:
        x = x[:, batch["img_embeds"].shape[1]:]
    group = vocab_group(params, cfg)
    if cfg.xent_chunk:
        return L.tied_xent_chunked(params["embed"], x, labels, cfg.vocab, cfg.xent_chunk, group)
    return L.softmax_xent(L.lm_logits(params["embed"], x, cfg.vocab, group), labels, group=group)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode over a KV cache
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


# --- RARO dense-tier quantized KV (kv_bits = 8 / 4) ------------------------
def _kv_qmax(bits: int) -> float:
    return 127.0 if bits == 8 else 7.0


def quant_kv(x, bits: int):
    """x: (..., dh) -> (q int8 (packed for 4-bit), scale (...,) f32)."""
    x32 = x.float()
    qmax = _kv_qmax(bits)
    amax = torch.clamp(torch.amax(torch.abs(x32), dim=-1), min=1e-8)
    # a tensor divisor: on CUDA, torch computes `tensor / python_scalar` as a
    # multiply by the reciprocal, which can move the scale by an ulp
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = quant.pack_int4(q)
    return q, scale


def dequant_kv(q, scale, bits: int, dtype):
    if bits == 4:
        q = quant.unpack_int4(q)
    return (q.float() * scale[..., None]).to(dtype)


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """Materialize with ``dtype=None``, so that int8 codes stay int8."""
    s = cache_len(cfg, seq_len)
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_bits == 16:
        kv = ParamSpec((cfg.n_layers, batch, s, hk, dh),
                       ("layers", None, None, "kv_heads", None), "zeros", cfg.dtype)
        return {"k": kv, "v": kv}
    dhq = dh if cfg.kv_bits == 8 else dh // 2
    kv = ParamSpec((cfg.n_layers, batch, s, hk, dhq),
                   ("layers", None, None, "kv_heads", None), "zeros", torch.int8)
    sc = ParamSpec((cfg.n_layers, batch, s, hk),
                   ("layers", None, None, "kv_heads"), "ones", torch.float32)
    return {"k": kv, "v": kv, "k_scale": sc, "v_scale": sc}


def prefill_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True):
    """Attention over the prompt (causal unless told otherwise; whisper's
    encoder and cross-attention are not): the flash kernel on the card when
    the model has no window, else the plain blockwise attention (on the CPU,
    as the reference computes it, and for sliding windows; the meta device
    takes the kernel's stand-in)."""
    if cfg.window == 0 and q.device.type != "cpu":
        return flash_ops.flash_attention(q, k, v, causal=causal)
    return attn.blockwise_attention(q, k, v, causal=causal, window=cfg.window)


def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence pass that also materializes the KV cache.

    batch: {"tokens": (B, S) int}, and for ``vlm`` "img_embeds": (B, N, D),
    prepended as in ``forward``. Returns (last-position logits (B, 1, V),
    cache dict), the cache exactly ``cache_len(cfg, N + S)`` long. Its
    spans (``repro_torch.spans``): ``prefill.embed``, each layer's
    ``prefill.qkv``, ``prefill.attention``, ``prefill.out`` and
    ``prefill.mlp``, then ``prefill.head`` and ``prefill.cache``.
    """
    with spans.span("prefill.embed"):
        x = _embed_inputs(params, batch, cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        with spans.span("prefill.qkv"):
            xn = norm(cfg, lp["ln1"], x)
            q, k, v = qkv(lp["attn"], xn, cfg, positions)
        with spans.span("prefill.attention"):
            o = prefill_attention(q, k, v, cfg)
        with spans.span("prefill.out"):
            h = x + L.matmul(o.reshape(b, s, -1), lp["attn"]["wo"])
        with spans.span("prefill.mlp"):
            x = h + L.mlp(lp["mlp"], norm(cfg, lp["ln2"], h), cfg.act)
        ks.append(k)
        vs.append(v)
    with spans.span("prefill.head"):
        x = norm(cfg, params["ln_f"], x)
        logits = L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    with spans.span("prefill.cache"):
        w = cache_len(cfg, s)
        ks, vs = torch.stack(ks)[:, :, -w:], torch.stack(vs)[:, :, -w:]
        if cfg.kv_bits == 16:
            cache = {"k": ks, "v": vs}
        else:
            qk, sk = quant_kv(ks, cfg.kv_bits)
            qv, sv = quant_kv(vs, cfg.kv_bits)
            cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return logits, cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions.

    ``cache`` is {"k", "v"}: (L, B, S, Hk, Dh), and with kv_bits < 16 the
    int8 (or packed int4, Dh/2) codes plus {"k_scale", "v_scale"}: (L, B, S,
    Hk) per-token scales, dequantized on every read. The write index is
    ``pos % S`` (rolling buffer). Returns (logits (B, 1, V), new cache).

    The embedding is cast to ``cfg.dtype``; with bf16 and f32 parameters the
    residual stream is bf16 only until the first residual add, and f32 after
    it. (The reference's ``lax.scan`` refuses that dtype change of its carry,
    so at bf16 the reference is the unrolled loop; see ROADMAP.md.)
    """
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    s_cache = cache["k"].shape[2]
    widx = (pos % s_cache).long()
    bidx = torch.arange(b, device=tokens.device)
    n_valid = torch.clamp(pos + 1, max=s_cache)
    bits = cfg.kv_bits
    new = {name: [] for name in cache}
    for i, lp in enumerate(params["layers"]):
        xn = norm(cfg, lp["ln1"], x)
        q, k, v = qkv(lp["attn"], xn, cfg, pos[:, None])
        if bits < 16:
            (qk, sk), (qv, sv) = quant_kv(k[:, 0], bits), quant_kv(v[:, 0], bits)
            writes = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        else:
            writes = {"k": k[:, 0], "v": v[:, 0]}
        layer = {name: cache[name][i].index_put((bidx, widx), val.to(cache[name].dtype))
                 for name, val in writes.items()}
        if bits < 16:
            k_full = dequant_kv(layer["k"], layer["k_scale"], bits, cfg.dtype)
            v_full = dequant_kv(layer["v"], layer["v_scale"], bits, cfg.dtype)
        else:
            k_full, v_full = layer["k"], layer["v"]
        o = attn.decode_attention(q, k_full, v_full, n_valid)
        h = x + L.matmul(o.reshape(b, 1, -1), lp["attn"]["wo"])
        x = h + L.mlp(lp["mlp"], norm(cfg, lp["ln2"], h), cfg.act)
        for name, t in layer.items():
            new[name].append(t)
    x = norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x, cfg.vocab)
    return logits, {name: torch.stack(ts) for name, ts in new.items()}
