"""Full tiered decode attention over a TieredKV cache (counterpart of
``repro.kernels.tiered_attention.ops``).

Runs one ``tiered_decode_partial`` per tier (+ a plain partial over the
write buffer), then combines flash-decoding style, and renormalizes the
per-page attention masses that feed the RARO controller.
"""

from __future__ import annotations

import torch

from repro_torch.core import modes
from repro_torch.kernels.tiered_attention.tiered_attention import NEG_INF, tiered_decode_partial
from repro_torch.kvcache import paged


def _buffer_partial(q, buf_k, buf_v, n_valid):
    """Partial over the open-page write buffer. q: (B,H,D); buf: (B,P,Hk,D);
    n_valid: (B,) tokens currently in the buffer."""
    b, h, d = q.shape
    _, p, hk, _ = buf_k.shape
    g = h // hk
    qh = (q.float() * d**-0.5).reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bphd->bhgp", qh, buf_k.float())
    mask = torch.arange(p, device=q.device)[None, :] < n_valid[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(dim=-1)
    acc = torch.einsum("bhgp,bphd->bhgd", pr, buf_v.float())
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def combine_partials(parts):
    """parts: list of (acc (B,H,D), m (B,H), l (B,H)) -> (out, M, L)."""
    M = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    out = torch.zeros_like(parts[0][0])
    for acc, m, l in parts:
        w = torch.exp(m - M)
        L = L + l * w
        out = out + acc * w[..., None]
    return out / torch.clamp(L, min=1e-30)[..., None], M, L


def tiered_decode_attention(q, cache: paged.TieredKV, cfg: paged.CacheConfig):
    """q: (B, H, D) -> (out (B,H,D), page_mass (B, MaxP)).

    page_mass[b, j] = attention probability mass on logical page j (mean
    over heads) — the RARO hotness signal.
    """
    b, h, d = q.shape
    q32 = q.float().contiguous()
    ones = torch.ones((cache.k16.shape[0], cfg.n_kv_heads), dtype=torch.float32, device=q.device)
    pools = {
        modes.TIER_BF16: (cache.k16, cache.v16, ones, ones),
        modes.TIER_INT8: (cache.k8, cache.v8, cache.sk8, cache.sv8),
        modes.TIER_INT4: (cache.k4, cache.v4, cache.sk4, cache.sv4),
    }
    parts, page_stats = [], []
    for tier, (kp, vp, sk, sv) in pools.items():
        slot_t = torch.where(cache.tier == tier, cache.slot, -1).to(torch.int32).contiguous()
        o, m, l, pp, pm = tiered_decode_partial(q32, kp, vp, sk, sv, slot_t, tier=tier)
        parts.append((o, m, l))
        page_stats.append((pp, pm))

    n_buf = cache.seq_len % cfg.page_size
    parts.append(_buffer_partial(q, cache.buf_k, cache.buf_v, n_buf))

    out, M, L = combine_partials(parts)

    # exact per-page mass: pp * exp(pm - M) / L, mean over heads
    mass = torch.zeros((b, cfg.max_pages), dtype=torch.float32, device=q.device)
    for pp, pm in page_stats:
        w = pp * torch.exp(pm - M[:, None, :])
        seen = (pm > NEG_INF / 2).any(dim=-1)
        mass = mass + (w / torch.clamp(L, min=1e-30)[:, None, :]).mean(dim=-1) * seen
    return out.to(q.dtype), mass
