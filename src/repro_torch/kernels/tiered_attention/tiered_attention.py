"""Tiered paged-decode attention: the per-tier flash-decoding partial.

Counterpart of ``repro.kernels.tiered_attention.tiered_attention``; the
kernel is ``csrc/tiered_attention.cu``. One call per RARO tier (the dtype and
dequantization are static per pool). For one decode token per sequence it
returns flash-decoding partials (acc, m, l) plus, per page, the exp-sum and
the running max it was taken against — the RARO hotness signal, which the
combiner in ``ops.py`` renormalizes. CUDA tensors go to the kernel; CPU
tensors to the plain version below.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modes
from repro_torch.kernels import build

NEG_INF = -1e30

_fn = None


def _dequant_block(kp, scale, tier: int):
    """kp: (..., P, Hk, D') pages; scale: (..., Hk) f32 -> (..., P, Hk, D) f32."""
    if tier == modes.TIER_BF16:
        return kp.float()
    if tier == modes.TIER_INT8:
        return kp.float() * scale[..., None, :, None]
    lo = ((kp & 0x0F) ^ 0x08) - 0x08
    hi = kp >> 4
    q = torch.stack([lo, hi], dim=-1).reshape(*kp.shape[:-1], -1)
    return q.float() * scale[..., None, :, None]


def tiered_decode_partial_plain(q, k_pool, v_pool, sk, sv, slot_table, *, tier: int):
    """Plain PyTorch version of the kernel: the same five outputs, a loop over
    the MaxP pages with the online softmax carried across it."""
    b, h, d = q.shape
    n, _, hk, _ = k_pool.shape
    g = h // hk
    mp = slot_table.shape[1]
    qh = (q.float() * d**-0.5).reshape(b, hk, g, d)
    m = torch.full((b, hk, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    page_p, page_m = [], []
    for j in range(mp):
        slot = slot_table[:, j].long()
        valid = (slot >= 0)[:, None, None]
        s_idx = torch.clamp(slot, 0, n - 1)
        k = _dequant_block(k_pool[s_idx], sk[s_idx], tier)  # (B, P, Hk, D)
        v = _dequant_block(v_pool[s_idx], sv[s_idx], tier)
        s = torch.einsum("bhgd,bphd->bhgp", qh, k)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        psum = p.sum(dim=-1)
        l = torch.where(valid, l * corr + psum, l)
        acc = torch.where(valid[..., None],
                          acc * corr[..., None] + torch.einsum("bhgp,bphd->bhgd", p, v), acc)
        m = torch.where(valid, m_new, m)
        page_p.append(torch.where(valid, psum, 0.0).reshape(b, h))
        page_m.append(torch.where(valid, m_new, NEG_INF).reshape(b, h))
    return (acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h),
            torch.stack(page_p, dim=1), torch.stack(page_m, dim=1))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("tiered_attention").tiered_decode_partial_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pool, v_pool, sk, sv, slot_table, tier):
    dev = q.device
    named = dict(q=q, k_pool=k_pool, v_pool=v_pool, sk=sk, sv=sv, slot_table=slot_table)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be (B, H, D) f32, got {tuple(q.shape)} {q.dtype}")
    b, h, d = q.shape
    if d % 4 or q.data_ptr() % 16:  # the kernel reads q and V rows 16 bytes at a time
        raise ValueError(f"the kernel needs D a multiple of 4 (got {d}) and q 16-byte aligned")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError("k_pool and v_pool must be (N, P, Hk, D') of one shape and dtype")
    n, _, hk, dp = k_pool.shape
    if n == 0 or h % hk:
        raise ValueError(f"need N > 0 pool pages and H ({h}) a multiple of Hk ({hk})")
    want = {modes.TIER_BF16: (torch.float32, torch.bfloat16),
            modes.TIER_INT8: (torch.int8,), modes.TIER_INT4: (torch.int8,)}
    if tier not in want or k_pool.dtype not in want[tier]:
        raise ValueError(f"tier {tier} does not take {k_pool.dtype} pools")
    if dp != (d // 2 if tier == modes.TIER_INT4 else d) or (tier == modes.TIER_INT4 and d % 2):
        raise ValueError(f"pool head dim {dp} does not fit D={d} at tier {tier}")
    for name, t in (("sk", sk), ("sv", sv)):
        if t.shape != (n, hk) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n}, {hk}) f32, got {tuple(t.shape)} {t.dtype}")
    if slot_table.dim() != 2 or slot_table.shape[0] != b or slot_table.dtype != torch.int32:
        raise ValueError(f"slot_table must be ({b}, MaxP) int32")


def tiered_decode_partial(q, k_pool, v_pool, sk, sv, slot_table, *, tier: int):
    """Per-tier flash-decoding partials.

    q: (B, H, D) f32, one token per sequence.
    k_pool/v_pool: (N, P, Hk, D') pages (D' = D, or D//2 when tier=int4).
    sk/sv: (N, Hk) f32 scales (unused for tier 0; pass ones).
    slot_table: (B, MaxP) int32 pool slots for THIS tier, -1 = not-this-tier.

    Returns (o (B,H,D) f32 unnormalized acc, m (B,H), l (B,H),
             page_p (B,MaxP,H) per-page exp-sums, page_m (B,MaxP,H) the
             running max each was taken against). ``tiered_decode_partial.launches``
             counts kernel launches.
    """
    if q.device.type == "cpu":
        return tiered_decode_partial_plain(q, k_pool, v_pool, sk, sv, slot_table, tier=tier)
    if q.device.type != "cuda":
        raise ValueError(f"tiered_decode_partial runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, sk, sv, slot_table, tier)
    b, h, d = q.shape
    n, p, hk, _ = k_pool.shape
    mp = slot_table.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, h, d), **f32)
    m = torch.empty((b, h), **f32)
    l = torch.empty((b, h), **f32)
    page_p = torch.empty((b, mp, h), **f32)
    page_m = torch.empty((b, mp, h), **f32)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), sk.data_ptr(), sv.data_ptr(),
                slot_table.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
                page_p.data_ptr(), page_m.data_ptr(), b, h, d, n, p, hk, mp, tier,
                int(k_pool.dtype == torch.bfloat16), d**-0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tiered_decode_partial kernel launch failed: CUDA error {rc}")
    tiered_decode_partial.launches += 1
    return o, m, l, page_p, page_m


tiered_decode_partial.launches = 0
