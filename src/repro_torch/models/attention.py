"""Attention primitives (counterpart of ``repro.models.attention``).

``blockwise_attention`` is the plain online-softmax attention over KV blocks
(a Python loop where the reference has ``lax.scan``): the prefill's attention
wherever the flash kernel does not apply (on the CPU, and for ``window > 0``).
``decode_attention`` is the single-token path over a dense KV cache (the
dense reference decode of the serve loop); ``reference_attention`` is the
naive O(S^2) oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _gqa_split(q, n_kv: int):
    """(B, S, H, D) -> (B, S, Hk, G, D) with G = H // Hk."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def blockwise_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                        window: int = 0, block: int = 1024):
    """Online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Sk, Hk, D); H % Hk == 0.
    q_offset: absolute position of q[0]. kv_len: (B,) valid cache length
    mask. window > 0 restricts attention to the last ``window`` positions.
    Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g = h // hk
    dv = v.shape[-1]  # v head dim may differ from k (MLA)
    block = min(block, sk)
    pad = -sk % block
    if pad:  # zero keys, masked below at k_pos >= Sk (the reference masks from Sk - pad,
        # dropping real keys: ROADMAP.md, queue 3)
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = _gqa_split(q, hk).float() * (d**-0.5)  # (B, Sq, Hk, G, D)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, sq, hk, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, hk, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hk, g, dv), dtype=torch.float32, device=q.device)
    for j0 in range(0, sk + pad, block):
        kj, vj = k[:, j0:j0 + block].float(), v[:, j0:j0 + block].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kj)
        k_pos = j0 + torch.arange(block, device=q.device)
        mask = (k_pos < sk)[None, :].expand(sq, block)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        if kv_len is not None:
            mask = mask[None] & (k_pos[None, None, :] < kv_len[:, None, None])
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        else:
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


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
