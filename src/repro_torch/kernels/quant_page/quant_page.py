"""Page-(re)quantization kernel wrapper — the RARO commit/migration hot path.

Counterpart of ``repro.kernels.quant_page.quant_page``; the kernel is
``csrc/quant_page.cu``. For each page (P, Hk, D): per-head symmetric scales,
the quantized page (int8, or int4 packed two per byte) and the page's
relative RMS error. CUDA tensors go to the kernel; CPU tensors to the plain
version in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import modes
from repro_torch.kernels import build
from repro_torch.kernels.quant_page.ref import quant_pages_ref

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("quant_page").quant_pages_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def quantize_pages(x, *, tier: int):
    """x: (N, P, Hk, D) f32/bf16 pages -> (q, scales (N, Hk), err (N, 1)).

    q is (N, P, Hk, D) int8 for tier=int8 or (N, P, Hk, D//2) packed for
    tier=int4. ``quantize_pages.launches`` counts kernel launches.
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
