"""Attention primitives (counterpart of ``repro.models.attention``).

``decode_attention`` is the single-token path over a dense KV cache (the
dense reference decode of the serve loop); ``reference_attention`` is the
naive O(S^2) oracle. ``blockwise_attention`` belongs to the prefill slice
and is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_split(q, n_kv: int):
    """(B, S, H, D) -> (B, S, Hk, G, D) with G = H // Hk."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """One-token attention over the cache.

    q: (B, 1, H, D); caches: (B, S, Hk, D); cache_len: (B,) — entries at
    positions >= cache_len are masked.
    """
    b, _, h, d = q.shape
    _, s, hk, _ = k_cache.shape
    qg = _gqa_split(q, hk).float() * (d**-0.5)
    scores = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_cache.float())
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, :] < cache_len[:, None]
    if window:
        mask &= k_pos[None, :] >= cache_len[:, None] - window
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def reference_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None, window: int = 0):
    """Naive O(S^2) oracle. q: (B, Sq, H, D); k, v: (B, Sk, Hk, D)."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    qg = _gqa_split(q, hk).float() * (d**-0.5)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask = mask[None].expand(b, sq, sk)
    if kv_len is not None:
        mask = mask & (k_pos[None, None, :] < kv_len[:, None, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
