"""Plain PyTorch version of the page-quantization kernel (over kvcache.quant);
counterpart of ``repro.kernels.quant_page.ref``."""

from __future__ import annotations

import torch

from repro_torch.core import modes
from repro_torch.kvcache import quant


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
