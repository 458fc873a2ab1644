"""Page-(re)quantization kernel wrappers — the RARO commit/migration hot path.

Counterpart of ``repro.kernels.quant_page.quant_page``; the kernel is
``csrc/quant_page.cu``, with two entries. ``quantize_pages``: for each page
(P, Hk, D), per-head symmetric scales, the quantized page (int8, or int4
packed two per byte) and the page's relative RMS error. ``quant_store_pages``:
the K and V pages of a batch of lanes, each quantized (or cast, for tier 0)
and stored straight into the slot its lane names in its tier's pools. CUDA
tensors go to the kernel; CPU tensors to the plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modes
from repro_torch.kernels import build
from repro_torch.kernels.quant_page.ref import (POOL_INDEX, TIERS, quant_pages_ref,
                                                quant_store_pages_ref)

_fns = {}


def _kernel(name="quant_pages_launch"):
    if name not in _fns:
        fn = getattr(build.load("quant_page"), name)
        if name == "quant_pages_launch":
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _aligned(name, t):
    # the kernel reads pages and writes codes 16 bytes at a time
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def quantize_pages(x, *, tier: int):
    """x: (N, P, Hk, D) f32/bf16 pages -> (q, scales (N, Hk), err (N, 1)).

    q is (N, P, Hk, D) int8 for tier=int8 or (N, P, Hk, D//2) packed for
    tier=int4. ``quantize_pages.launches`` counts launches of the kernel, by
    either entry.
    """
    if tier not in (modes.TIER_INT8, modes.TIER_INT4):
        raise ValueError(f"tier must be int8 ({modes.TIER_INT8}) or int4 ({modes.TIER_INT4})")
    if x.device.type == "cpu":
        q, s, e = quant_pages_ref(x, tier=tier)
        return q, s, e[:, None]
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pages runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, P, Hk, D) f32/bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, p, hk, d = x.shape
    int4 = tier == modes.TIER_INT4
    if int4 and d % 2:
        raise ValueError(f"int4 packing needs an even head dim, got {d}")
    if hk > 64:
        raise ValueError(f"at most 64 KV heads per page, got {hk}")
    _aligned("x", x)
    q = torch.empty((n, p, hk, d // 2 if int4 else d), dtype=torch.int8, device=x.device)
    s = torch.empty((n, hk), dtype=torch.float32, device=x.device)
    e = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s, e
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), e.data_ptr(), n, p, hk, d,
                int(x.dtype == torch.bfloat16), int(int4),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_pages kernel launch failed: CUDA error {rc}")
    quantize_pages.launches += 1
    return q, s, e


quantize_pages.launches = 0


def _check_store(kpage, vpage, tier, slot, pools):
    if kpage.dim() != 4 or kpage.shape != vpage.shape or kpage.dtype != vpage.dtype \
            or kpage.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kpage and vpage must be (B, P, Hk, D) f32/bf16 of one shape and "
                         f"dtype, got {tuple(kpage.shape)} {kpage.dtype} and "
                         f"{tuple(vpage.shape)} {vpage.dtype}")
    b, p, hk, d = kpage.shape
    if d % 2 or hk > 64:
        raise ValueError(f"need an even head dim and at most 64 KV heads, got D={d}, Hk={hk}")
    if len(pools) != 10:
        raise ValueError("pools must be (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4)")
    if pools[0].dtype not in (torch.float32, torch.bfloat16) or pools[1].dtype != pools[0].dtype:
        raise ValueError(f"tier-0 pools must be f32 or bf16, got {pools[0].dtype}")
    for t in TIERS:
        ik, iv, *isc = POOL_INDEX[t]
        n = pools[ik].shape[0]
        page = (n, p, hk, d // 2 if t == modes.TIER_INT4 else d)
        want = [(ik, page), (iv, page)] + [(i, (n, hk)) for i in isc]
        for i, shape in want:
            dt = pools[0].dtype if t == modes.TIER_BF16 else (
                torch.int8 if i in (ik, iv) else torch.float32)
            if tuple(pools[i].shape) != shape or pools[i].dtype != dt:
                raise ValueError(f"pool {i} must be {shape} {dt}, got "
                                 f"{tuple(pools[i].shape)} {pools[i].dtype}")
    named = [("kpage", kpage), ("vpage", vpage), ("tier", tier), ("slot", slot)]
    named += [(f"pool {i}", t) for i, t in enumerate(pools)]
    for name, t in named:
        if t.device != kpage.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {kpage.device}")
    for name, t in (("tier", tier), ("slot", slot)):
        if t.shape != (b,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({b},) int32, got {tuple(t.shape)} {t.dtype}")
    if max(t.numel() for t in (kpage, *pools)) >= 2**31:
        raise ValueError("the kernel indexes pages and pools with 32-bit offsets")


def quant_store_pages(kpage, vpage, tier, slot, pools, *, tiers=TIERS):
    """Quantize-and-store: lane b's K and V pages (B, P, Hk, D), f32 or bf16,
    go to slot ``slot[b]`` of the pools of tier ``tier[b]`` ((B,) int32 each):
    codes and per-head scales for tiers int8 and int4, the page cast to the
    pool's dtype for tier 0. Lanes whose slot is negative or beyond the pool,
    or whose tier is not in ``tiers``, are skipped.

    ``pools`` is (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4), as
    ``kvcache.paged`` holds them. Returns the same tuple with new tensors for
    the tiers in ``tiers`` and the given ones for the others; the given pools
    are left as they were. The routing is read on the device, so the call
    never waits on it. One launch, counted in ``quantize_pages.launches``.
    """
    tiers = tuple(sorted(set(tiers)))
    if not tiers or any(t not in TIERS for t in tiers):
        raise ValueError(f"tiers must be a non-empty subset of {TIERS}, got {tiers}")
    if kpage.device.type == "cpu":
        return quant_store_pages_ref(kpage, vpage, tier, slot, pools, tiers=tiers)
    if kpage.device.type != "cuda":
        raise ValueError(f"quant_store_pages runs on cuda or cpu, not {kpage.device}")
    _check_store(kpage, vpage, tier, slot, pools)
    out = list(pools)
    for t in tiers:
        for i in POOL_INDEX[t]:
            out[i] = pools[i].clone()
    b, p, hk, d = kpage.shape
    if b == 0:
        return tuple(out)
    _aligned("kpage", kpage)
    _aligned("vpage", vpage)
    for i, t in enumerate(out):
        _aligned(f"pool {i}", t)
    fn = _kernel("quant_store_pages_launch")
    with torch.cuda.device(kpage.device):
        rc = fn(kpage.data_ptr(), vpage.data_ptr(), tier.data_ptr(), slot.data_ptr(),
                *[t.data_ptr() for t in out], b, p, hk, d, out[0].shape[0], out[2].shape[0],
                out[6].shape[0], int(kpage.dtype == torch.bfloat16),
                int(out[0].dtype == torch.bfloat16), sum(1 << t for t in tiers),
                torch.cuda.current_stream(kpage.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_store_pages kernel launch failed: CUDA error {rc}")
    quantize_pages.launches += 1
    return tuple(out)
