"""Plain oracle for tiered paged-decode attention: gather, dense softmax over
the dequantized logical sequence, per-page masses (counterpart of
``repro.kernels.tiered_attention.ref``)."""

from __future__ import annotations

import torch

from repro_torch.kvcache import paged

NEG_INF = -1e30


def tiered_decode_attention_ref(q, cache: paged.TieredKV, cfg: paged.CacheConfig):
    """q: (B, H, D) -> (out (B,H,D) f32, page_mass (B, MaxP))."""
    b, h, d = q.shape
    p, mp, hk = cfg.page_size, cfg.max_pages, cfg.n_kv_heads
    g = h // hk

    K, V = paged.gather_kv(cache, cfg, torch.float32)  # (B, MP, P, Hk, D)
    K = torch.cat([K.reshape(b, mp * p, hk, d), cache.buf_k.float()], dim=1)
    V = torch.cat([V.reshape(b, mp * p, hk, d), cache.buf_v.float()], dim=1)

    committed = (cache.tier >= 0)[:, :, None]  # (B, MP, 1)
    valid_pool = committed.expand(b, mp, p).reshape(b, mp * p)
    n_buf = cache.seq_len % p
    valid_buf = torch.arange(p, device=q.device)[None, :] < n_buf[:, None]
    valid = torch.cat([valid_pool, valid_buf], dim=1)  # (B, MP*P + P)

    qh = (q.float() * d**-0.5).reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qh, K)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = pr.sum(dim=-1, keepdim=True)
    probs = pr / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, V).reshape(b, h, d)

    mass = probs.mean(dim=(1, 2))[:, : mp * p].reshape(b, mp, p).sum(dim=-1)
    return out, mass
