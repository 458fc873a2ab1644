"""Tiered paged KV cache — the RARO technique as a serving feature.

Counterpart of ``repro.kvcache.paged``. Layout (one attention layer):

  * an open-page WRITE BUFFER per sequence (fresh tokens always start at
    full precision);
  * three fixed POOLS, one per tier: bf16 / int8 / packed-int4 pages of
    ``page_size`` tokens with per-(page, head) scales (tier ids == flash
    mode ids, see core.modes);
  * a (tier, slot) page table per sequence plus per-logical-page metadata
    (hotness, birth step, requant count, reads) feeding the RARO
    controller in tiers.py.

Functions return a new ``TieredKV`` and leave their input as it was. The
reference's drop-mode scatters send masked lanes to an out-of-range index;
here they go to a trailing row that is sliced off (``scatter_drop``), so that
no write needs a boolean mask: on a card, ``append`` and the RARO controller
never make the host wait for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import modes
from repro_torch.kernels.quant_page.ops import quant_store_pages
from repro_torch.kernels.quant_page.ref import scatter_drop
from repro_torch.kvcache import quant


@dataclass(frozen=True)
class CacheConfig:
    n_seqs: int
    max_pages: int  # logical pages per sequence
    page_size: int
    n_kv_heads: int
    head_dim: int
    pool_pages: tuple[int, int, int] = (64, 128, 1024)  # bf16 / int8 / int4
    migrate_per_step: int = 8
    # pool-pressure watermark for elastic recovery (fraction occupied)
    high_watermark: float = 0.9


class TieredKV(NamedTuple):
    # write buffer (open page per sequence)
    buf_k: torch.Tensor  # (B, P, Hk, Dh)
    buf_v: torch.Tensor
    # pools
    k16: torch.Tensor  # (N0, P, Hk, Dh) tier 0, in the dtype init was given
    v16: torch.Tensor
    k8: torch.Tensor  # (N1, P, Hk, Dh) int8
    v8: torch.Tensor
    sk8: torch.Tensor  # (N1, Hk) f32
    sv8: torch.Tensor
    k4: torch.Tensor  # (N2, P, Hk, Dh//2) packed int4
    v4: torch.Tensor
    sk4: torch.Tensor
    sv4: torch.Tensor
    # page tables
    tier: torch.Tensor  # (B, MaxP) int32, -1 = empty
    slot: torch.Tensor  # (B, MaxP) int32
    seq_len: torch.Tensor  # (B,) int32
    # pool free masks
    free: tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (Nt,) bool each
    # per-logical-page metadata (RARO inputs)
    hot: torch.Tensor  # (B, MaxP) f32 decayed attention mass
    born: torch.Tensor  # (B, MaxP) i32 step of commit
    requants: torch.Tensor  # (B, MaxP) i32 quantization events
    reads: torch.Tensor  # (B, MaxP) f32 attention-mass-weighted reads
    step: torch.Tensor  # i32 scalar


def init(cfg: CacheConfig, dtype=torch.bfloat16, device=None) -> TieredKV:
    device = resolve_device(device)
    b, mp, p, hk, dh = cfg.n_seqs, cfg.max_pages, cfg.page_size, cfg.n_kv_heads, cfg.head_dim
    n0, n1, n2 = cfg.pool_pages
    f32, i32, i8 = torch.float32, torch.int32, torch.int8

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=f32, device=device)

    return TieredKV(
        buf_k=zeros((b, p, hk, dh), dtype),
        buf_v=zeros((b, p, hk, dh), dtype),
        k16=zeros((n0, p, hk, dh), dtype),
        v16=zeros((n0, p, hk, dh), dtype),
        k8=zeros((n1, p, hk, dh), i8),
        v8=zeros((n1, p, hk, dh), i8),
        sk8=ones((n1, hk)),
        sv8=ones((n1, hk)),
        k4=zeros((n2, p, hk, dh // 2), i8),
        v4=zeros((n2, p, hk, dh // 2), i8),
        sk4=ones((n2, hk)),
        sv4=ones((n2, hk)),
        tier=torch.full((b, mp), -1, dtype=i32, device=device),
        slot=torch.full((b, mp), -1, dtype=i32, device=device),
        seq_len=zeros((b,), i32),
        free=tuple(torch.ones((n,), dtype=torch.bool, device=device) for n in (n0, n1, n2)),
        hot=zeros((b, mp), f32),
        born=zeros((b, mp), i32),
        requants=zeros((b, mp), i32),
        reads=zeros((b, mp), f32),
        step=zeros((), i32),
    )


def _alloc(free, want_b):
    """Allocate one slot per True entry of want_b (B,). Returns (slots (B,),
    new free). Over-subscription yields -1 for the losers. Free slots are
    handed out lowest id first (a stable sort of the busy flags)."""
    n = free.shape[0]
    order = torch.argsort((~free).to(torch.int8), stable=True)  # free slots first
    rank = torch.cumsum(want_b.to(torch.int32), dim=0, dtype=torch.int32) - 1
    avail = free.sum()
    slots = torch.where(want_b & (rank < avail), order[torch.clamp(rank, 0, n - 1).long()], -1)
    new_free = scatter_drop(free, torch.where(slots >= 0, slots, n), False)
    return slots.to(torch.int32), new_free


def _load_page(c: TieredKV, tiers, slots, dtype=torch.bfloat16):
    """Gather + dequantize logical pages. tiers/slots: (...,) -> K,V of
    shape (..., P, Hk, Dh). Invalid (tier<0) pages come back as zeros."""
    t = torch.clamp(tiers, min=0)[..., None, None, None]
    s0 = torch.clamp(slots, 0, c.k16.shape[0] - 1).long()
    s1 = torch.clamp(slots, 0, c.k8.shape[0] - 1).long()
    s2 = torch.clamp(slots, 0, c.k4.shape[0] - 1).long()
    valid = (tiers >= 0)[..., None, None, None]

    def pick(p16, p8, s8, p4, s4):
        x = torch.where(
            t == 0,
            p16[s0].to(dtype),
            torch.where(t == 1, quant.dequantize_int8(p8[s1], s8[s1], dtype),
                        quant.dequantize_int4(p4[s2], s4[s2], dtype)),
        )
        return torch.where(valid, x, torch.zeros((), dtype=dtype, device=x.device))

    return (pick(c.k16, c.k8, c.sk8, c.k4, c.sk4), pick(c.v16, c.v8, c.sv8, c.v4, c.sv4))


def append(c: TieredKV, cfg: CacheConfig, k_new, v_new, commit_tier):
    """Append one token's KV per sequence (k_new/v_new: (B, Hk, Dh)).

    When a buffer page fills, it is committed to the pool of
    ``commit_tier[b]`` (the RARO write-path decision from tiers.py); an
    exhausted pool falls back to the next denser tier.
    """
    b, p, mp = cfg.n_seqs, cfg.page_size, cfg.max_pages
    off = (c.seq_len % p).long()
    bidx = torch.arange(b, device=c.seq_len.device)
    buf_k = c.buf_k.index_put((bidx, off), k_new.to(c.buf_k.dtype))
    buf_v = c.buf_v.index_put((bidx, off), v_new.to(c.buf_v.dtype))
    seq_len = c.seq_len + 1
    page_full = (seq_len % p) == 0
    page_idx = torch.clamp((seq_len - 1) // p, max=mp - 1).long()  # logical page committed

    free = list(c.free)
    commit = commit_tier.to(torch.int32)
    # the tier and slot each full page lands in (-1: none), then one store
    tier_new = torch.full_like(commit, -1)
    slot_new = torch.full_like(commit, -1)
    for t in (modes.TIER_BF16, modes.TIER_INT8, modes.TIER_INT4):
        want = page_full & (commit == t)
        slots, free[t] = _alloc(free[t], want)
        # pool exhausted -> fall back to the next denser tier
        failed = want & (slots < 0)
        commit = torch.where(failed, min(t + 1, modes.TIER_INT4), commit)
        ok = slots >= 0
        tier_new = torch.where(ok, t, tier_new)
        slot_new = torch.where(ok, slots, slot_new)
    pools = (c.k16, c.v16, c.k8, c.v8, c.sk8, c.sv8, c.k4, c.v4, c.sk4, c.sv4)
    (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4) = quant_store_pages(
        buf_k, buf_v, tier_new, slot_new, pools)

    # each lane names its own table entry (bidx, page_idx), so a gather and a
    # where write exactly the committed lanes
    ok = slot_new >= 0
    at = (bidx, page_idx)
    tier_tab, slot_tab = c.tier.clone(), c.slot.clone()
    born, requants = c.born.clone(), c.requants.clone()
    tier_tab[at] = torch.where(ok, tier_new, tier_tab[at])
    slot_tab[at] = torch.where(ok, slot_new, slot_tab[at])
    born[at] = torch.where(ok, c.step, born[at])
    requants[at] = requants[at] + (ok & (tier_new != modes.TIER_BF16)).to(torch.int32)
    return c._replace(
        buf_k=buf_k, buf_v=buf_v, k16=k16, v16=v16, k8=k8, v8=v8, sk8=sk8,
        sv8=sv8, k4=k4, v4=v4, sk4=sk4, sv4=sv4, tier=tier_tab, slot=slot_tab,
        seq_len=seq_len, free=tuple(free), born=born, requants=requants,
        step=c.step + 1,
    )


def gather_kv(c: TieredKV, cfg: CacheConfig, dtype=torch.bfloat16):
    """Plain read path: dequantize every committed page into dense
    (B, MaxP, P, Hk, Dh) K/V (tests and the attention oracle)."""
    return _load_page(c, c.tier, c.slot, dtype)


def pool_occupancy(c: TieredKV):
    return tuple(1.0 - f.float().mean() for f in c.free)


def memory_bytes(c: TieredKV, cfg: CacheConfig):
    """Bytes of committed pages (the 'capacity' axis of the paper). Tier 0
    counts 2 bytes per element whatever the pool's dtype, as the reference
    does."""
    p, hk, dh = cfg.page_size, cfg.n_kv_heads, cfg.head_dim
    page_b = {0: 2 * p * hk * dh * 2, 1: 2 * p * hk * dh, 2: p * hk * dh}
    used = [int((~f).sum()) for f in c.free]
    return sum(u * page_b[t] for t, u in enumerate(used))
