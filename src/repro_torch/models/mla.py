"""Multi-head Latent Attention (DeepSeek-V2/V3); counterpart of
``repro.models.mla``.

Train and prefill run the explicit (decompressed) form: the latent is
expanded to per-head keys and values, and the causal attention is
``transformer.train_attention`` in a training forward and
``transformer.prefill_attention`` in the prefill, so on the card both reach
the flash kernel, whose query and key heads are ``nope + rope`` wide (192
for deepseek-v3) beside a value head of ``v_head_dim`` (128); elsewhere both
are the plain blockwise attention, as the reference computes it. Decode runs
the *absorbed* form: q is projected into the KV latent space, so attention
contracts directly against the cached compressed latents. The cache is
(c_kv, k_rope): kv_lora_rank + rope_head_dim values per position instead of
2 * H * d_head, the latent page that the RARO KV tiers would manage for
deepseek-v3 (DESIGN.md §5).

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules), the training forward is
tensor-parallel over the heads (``parallel/tensor.py``): ``wq_b`` and
``wkv_b`` are column-parallel, from the replicated q latent and the
replicated KV latent ``c_kv``; ``wo`` is row-parallel. ``wq_a``, ``wkv_a``
and both latent norms stay whole, and nothing is gathered. The shared rope
key ``k_rope`` is read by every local head, so it also goes through
``replicated``: its cotangent is partial on each rank. The flash kernel then
runs at the rank's heads. Decode (serving) runs on one device.
"""

from __future__ import annotations

import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import collectives as C
from repro_torch.parallel import tensor


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": ParamSpec((d, ql), ("embed", None), "scaled"),
        "q_ln": L.rmsnorm_specs(ql),
        "wq_b": ParamSpec((ql, h * (dn + dr)), (None, "heads"), "scaled"),
        "wkv_a": ParamSpec((d, kl + dr), ("embed", None), "scaled"),
        "kv_ln": L.rmsnorm_specs(kl),
        "wkv_b": ParamSpec((kl, h * (dn + dv)), (None, "heads"), "scaled"),
        "wo": ParamSpec((h * dv, d), ("heads", "embed"), "scaled"),
    }


def _project_q(p, x, cfg: ModelConfig, positions, group=None):
    """(q_nope, q_rope roped), at the heads ``wq_b`` holds: this rank's,
    column-parallel from the replicated latent, where ``group`` splits
    them."""
    b, s, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    q_lat = L.rmsnorm(p["q_ln"], L.matmul(x, p["wq_a"]))
    q = (L.matmul(q_lat, p["wq_b"]) if group is None
         else tensor.column(q_lat, [p["wq_b"]], group)[0])
    q = q.reshape(b, s, -1, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = L.apply_rope(qr, positions, cfg.rope_theta)
    return qn, qr


def _project_kv_latent(p, x, cfg: ModelConfig, positions):
    """x -> (c_kv normalized (B, S, KL), k_rope roped (B, S, DR))."""
    kl = cfg.kv_lora_rank
    kv_a = L.matmul(x, p["wkv_a"])
    ckv = L.rmsnorm(p["kv_ln"], kv_a[..., :kl])
    kr = kv_a[..., kl:]
    kr = L.apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def mla_attention(p, x, cfg: ModelConfig, positions, return_cache: bool = False,
                  attention=T.train_attention):
    """Explicit-form MLA for train and prefill. Returns out [, (c_kv, k_rope)].

    ``attention(q, k, v, cfg)`` is the causal attention: the training
    forward's (the default) or ``transformer.prefill_attention``. ``v`` is a
    strided slice of the expanded latent, which the flash kernel reads in
    place."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = p["wq_b"].shape[-1] // (dn + dr)  # this rank's heads where they are split
    group = tensor.split_group(h, cfg.n_heads)

    qn, qr = _project_q(p, x, cfg, positions, group)
    ckv, kr = _project_kv_latent(p, x, cfg, positions)
    if group is not None:  # every local head reads both: their cotangents are partial
        ckv, kr = C.replicated(ckv, group), C.replicated(kr, group)

    kv = L.matmul(ckv, p["wkv_b"]).reshape(b, s, h, dn + dv)
    kn, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([kn, kr[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)

    o = attention(q, k, v, cfg).reshape(b, s, h * dv)
    out = L.matmul(o, p["wo"]) if group is None else tensor.row(o, p["wo"], group)
    if return_cache:
        return out, (ckv, kr)
    return out


def mla_decode(p, x, cfg: ModelConfig, pos, ckv_cache, kr_cache):
    """Absorbed-form single-token decode.

    x: (B, 1, D); pos: (B,); caches: (B, S, KL) and (B, S, DR), written at
    ``pos % S``. Returns (out, caches). The products are f32 einsums, as the
    reference takes them outside any kernel.
    """
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kl = cfg.kv_lora_rank
    s_cache = ckv_cache.shape[1]
    rows = torch.arange(b, device=x.device) * s_cache + (pos % s_cache).long()

    qn, qr = _project_q(p, x, cfg, pos[:, None])
    ckv_new, kr_new = _project_kv_latent(p, x, cfg, pos[:, None])

    def write(cache, new):  # cache.at[bidx, widx].set(new) on the (B·S, ...) rows
        flat = cache.reshape(b * s_cache, cache.shape[-1])
        return ops.at_set(flat, rows, new.to(cache.dtype)).reshape(cache.shape)

    ckv_cache = write(ckv_cache, ckv_new[:, 0])
    kr_cache = write(kr_cache, kr_new[:, 0])

    w_b = p["wkv_b"].reshape(kl, h, dn + dv)
    w_uk, w_uv = w_b[..., :dn], w_b[..., dn:]

    q_lat = torch.einsum("bqhd,lhd->bqhl", qn.float(), w_uk.float())
    scores = torch.einsum("bqhl,bkl->bqhk", q_lat, ckv_cache.float())
    scores = scores + torch.einsum("bqhd,bkd->bqhk", qr.float(), kr_cache.float())
    scores = scores * (dn + dr) ** -0.5

    k_pos = torch.arange(s_cache, device=x.device)
    mask = k_pos[None, :] < torch.clamp(pos + 1, max=s_cache)[:, None]
    scores = torch.where(mask[:, None, None, :], scores, attn.NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)

    ctx = torch.einsum("bqhk,bkl->bqhl", probs, ckv_cache.float())
    o = torch.einsum("bqhl,lhd->bqhd", ctx, w_uv.float()).to(x.dtype)
    out = L.matmul(o.reshape(b, 1, h * dv), p["wo"])
    return out, ckv_cache, kr_cache
