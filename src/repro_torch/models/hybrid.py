"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention + MLP
block applied after every ``attn_every`` Mamba2 layers (counterpart of
``repro.models.hybrid``, arXiv:2411.15242).

The shared block's attention is windowed (``cfg.window``), so its prefill
takes the plain blockwise attention (``transformer.prefill_attention``
routes windowed models there, on the card too); decode attends over the
whole rolling cache, as the reference's does. Mamba2 layers are a Python
list (``mamba_layers``); the state keeps the reference's stacked layout:
{"mamba": {"S", "conv"}: (L, ...)} and one KV cache per application of the
shared block, {"k", "v"}: (n_apps, B, W, Hk, Dh).

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules), the embedding and the tied head with
its cross-entropy split the vocabulary; each Mamba2 layer gathers its
``in_proj`` and splits its ``gn``/``out_proj`` (``ssm.py``); the shared
block's attention runs on this rank's heads (``transformer.attn_block``)
and its MLP on this rank's block of the width. The shared block runs
``n_apps`` times, so each rank's blocks of its leaves sum their gradient
over the applications, as one device does. Serving runs on one device.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import tensor


def n_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def idle_params(cfg: ModelConfig) -> tuple[str, ...]:
    """The shared block when no segment reaches it (``attn_every`` above
    ``n_layers``): the loss does not reach its parameters."""
    return ("shared",) if cfg.attn_every and not n_apps(cfg) else ()


def specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "mamba_layers": [ssm.mamba2_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_f": T.norm_specs(cfg),
    }
    if cfg.attn_every:
        s["shared"] = {
            "ln1": T.norm_specs(cfg),
            "attn": T.attn_specs(cfg),
            "ln2": T.norm_specs(cfg),
            "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=True),
        }
    return s


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    out = {"mamba": T.stack_specs(cfg.n_layers, ssm.mamba2_state_specs(cfg, batch))}
    if cfg.attn_every:
        w = T.cache_len(cfg, seq_len)
        kv = ParamSpec((n_apps(cfg), batch, w, cfg.n_kv_heads, cfg.head_dim),
                       (None, None, None, "kv_heads", None), "zeros", cfg.dtype)
        out.update({"k": kv, "v": kv})
    return out


def _segments(cfg: ModelConfig):
    """(start, length, has_attn) per segment: the shared block fires after
    each full ``attn_every`` Mamba2 layers; a shorter tail has none."""
    k = cfg.attn_every or cfg.n_layers
    segs = []
    i = 0
    while i < cfg.n_layers:
        ln = min(k, cfg.n_layers - i)
        segs.append((i, ln, bool(cfg.attn_every) and ln == k))
        i += ln
    return segs


def _mamba_run(layers, x, cfg: ModelConfig, states=None):
    """Mamba2 layers over x, each from its state (zeros if None; else a dict
    of leaves stacked over these layers) -> (x, a list of their new states)."""
    new = []
    for i, lp in enumerate(layers):
        st = None if states is None else {k: v[i] for k, v in states.items()}
        y, st = ssm.mamba2_apply(lp, x, cfg, st)
        x = x + y
        new.append(st)
    return x, new


def _stack_states(per_layer):
    return {k: torch.stack([st[k] for st in per_layer]) for k in per_layer[0]}


def _shared_mlp(sp, x, cfg: ModelConfig):
    return x + L.mlp(sp["mlp"], T.norm(cfg, sp["ln2"], x), cfg.act,
                     tensor.mlp_group(sp["mlp"], cfg.d_ff))


def forward(params, batch, cfg: ModelConfig):
    x = L.embed(params["embed"], batch["tokens"], T.vocab_group(params, cfg)).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for start, length, has_attn in _segments(cfg):
        x, _ = _mamba_run(params["mamba_layers"][start:start + length], x, cfg)
        if has_attn:
            sp = params["shared"]
            x = x + T.attn_block(sp["attn"], T.norm(cfg, sp["ln1"], x), cfg, positions)
            x = _shared_mlp(sp, x, cfg)
    return T.norm(cfg, params["ln_f"], x)


def loss_fn(params, batch, cfg: ModelConfig):
    x = forward(params, batch, cfg)
    group = T.vocab_group(params, cfg)
    return L.softmax_xent(L.lm_logits(params["embed"], x, cfg.vocab, group), batch["labels"],
                          group=group)


def prefill(params, batch, cfg: ModelConfig):
    """batch: {"tokens": (B, S)} -> (last-position logits (B, 1, V), cache),
    each application's K and V its last ``cache_len(cfg, S)`` positions."""
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    w = T.cache_len(cfg, s)
    m_states, ks, vs = [], [], []
    for start, length, has_attn in _segments(cfg):
        x, st = _mamba_run(params["mamba_layers"][start:start + length], x, cfg)
        m_states += st
        if has_attn:
            sp = params["shared"]
            q, k, v = T.qkv(sp["attn"], T.norm(cfg, sp["ln1"], x), cfg, positions)
            o = T.prefill_attention(q, k, v, cfg)
            x = x + L.matmul(o.reshape(b, s, -1), sp["attn"]["wo"])
            x = _shared_mlp(sp, x, cfg)
            ks.append(k[:, -w:])
            vs.append(v[:, -w:])
    x = T.norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    cache = {"mamba": _stack_states(m_states)}
    if ks:
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
    return logits, cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions; the
    shared block writes its K and V at ``pos % W`` and attends over the
    whole cache (no window), as the reference does."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    bidx = torch.arange(b, device=tokens.device)
    new_m, new_k, new_v = [], [], []
    app = 0
    for start, length, has_attn in _segments(cfg):
        states = {k: v[start:start + length] for k, v in cache["mamba"].items()}
        x, st = _mamba_run(params["mamba_layers"][start:start + length], x, cfg, states)
        new_m += st
        if has_attn:
            sp = params["shared"]
            kc, vc = cache["k"][app], cache["v"][app]
            s_cache = kc.shape[1]
            widx = (pos % s_cache).long()
            q, k, v = T.qkv(sp["attn"], T.norm(cfg, sp["ln1"], x), cfg, pos[:, None])
            kc = kc.index_put((bidx, widx), k[:, 0].to(kc.dtype))
            vc = vc.index_put((bidx, widx), v[:, 0].to(vc.dtype))
            o = attn.decode_attention(q, kc, vc, torch.clamp(pos + 1, max=s_cache))
            x = x + L.matmul(o.reshape(b, 1, -1), sp["attn"]["wo"])
            x = _shared_mlp(sp, x, cfg)
            new_k.append(kc)
            new_v.append(vc)
            app += 1
    x = T.norm(cfg, params["ln_f"], x)
    out = {"mamba": _stack_states(new_m)}
    if new_k:
        out["k"], out["v"] = torch.stack(new_k), torch.stack(new_v)
    return L.lm_logits(params["embed"], x, cfg.vocab), out
