"""Plain PyTorch version of the page-quantization kernel (over kvcache.quant);
counterpart of ``repro.kernels.quant_page.ref``, plus the plain version of the
kernel's store entry."""

from __future__ import annotations

import torch

from repro_torch.core import modes
from repro_torch.kvcache import quant

# where each tier's tensors sit in the pools tuple
# (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4): codes of K and V, then scales
POOL_INDEX = {modes.TIER_BF16: (0, 1), modes.TIER_INT8: (2, 3, 4, 5),
              modes.TIER_INT4: (6, 7, 8, 9)}
TIERS = (modes.TIER_BF16, modes.TIER_INT8, modes.TIER_INT4)


def quant_pages_ref(x, *, tier: int):
    """x: (N, P, Hk, D) -> (codes, scales (N, Hk), err (N,))."""
    if tier == modes.TIER_INT8:
        q, s = quant.quantize_int8(x)
        xd = quant.dequantize_int8(q, s, torch.float32)
    else:
        q, s = quant.quantize_int4(x)
        xd = quant.dequantize_int4(q, s, torch.float32)
    x32 = x.float()
    err = torch.sqrt(torch.mean((x32 - xd) ** 2, dim=(1, 2, 3))) / (
        torch.sqrt(torch.mean(x32**2, dim=(1, 2, 3))) + 1e-8
    )
    return q, s, err


def scatter_drop(dst, idx, src):
    """A new ``dst`` with rows ``idx`` (long, in [0, n]) set to ``src`` (a
    tensor, or a Python scalar), where index n drops its lane: the reference's
    ``.at[idx].set(src, mode="drop")``. Dropped lanes land in a trailing row
    that is sliced off, so no boolean mask is taken: on a card, a mask's
    ``nonzero`` makes the host wait, as does a scalar given as an index value
    (it is copied to the card), so a scalar is filled in instead."""
    ext = torch.cat([dst, dst.new_empty((1, *dst.shape[1:]))])
    if isinstance(src, torch.Tensor):
        ext[idx] = src
    else:
        ext.index_fill_(0, idx, src)
    return ext[: dst.shape[0]]


def quant_store_pages_ref(kpage, vpage, tier, slot, pools, *, tiers=TIERS):
    """Plain version of ``quant_store_pages``: every lane's K and V page
    (B, P, Hk, D) quantized (or, for tier 0, cast) and stored at ``slot[b]`` of
    the pools of ``tier[b]``; lanes whose slot is outside the pool, or whose
    tier is not in ``tiers``, are dropped. Returns the ten pool tensors, new
    ones for the tiers in ``tiers``."""
    out = list(pools)
    for t in tiers:
        idx = POOL_INDEX[t]
        n = pools[idx[0]].shape[0]
        row = torch.where((tier == t) & (slot >= 0) & (slot < n), slot, n).long()
        if t == modes.TIER_BF16:
            vals = (kpage.to(pools[0].dtype), vpage.to(pools[1].dtype))
        else:
            qk, sk, _ = quant_pages_ref(kpage, tier=t)
            qv, sv, _ = quant_pages_ref(vpage, tier=t)
            vals = (qk, qv, sk, sv)
        for i, val in zip(idx, vals):
            out[i] = scatter_drop(pools[i], row, val)
    return tuple(out)
