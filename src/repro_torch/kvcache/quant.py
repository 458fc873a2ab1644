"""KV-page quantization: bf16 <-> int8 <-> packed int4, per-(page, head)
symmetric scales (counterpart of ``repro.kvcache.quant``).

  tier 0 (SLC analogue)  bf16   — fastest/most-reliable read
  tier 1 (TLC analogue)  int8
  tier 2 (QLC analogue)  int4   — densest, highest dequant error

Plain PyTorch; these are also the plain version the CUDA ``quant_page``
kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.core import modes

INT4_MAX = 7.0
INT8_MAX = 127.0


def quant_scales(x, qmax: float):
    """x: (..., P, H, D) -> per-(page-leading..., H) scale over (P, D)."""
    amax = torch.clamp(torch.amax(torch.abs(x.float()), dim=(-3, -1)), min=1e-8)
    # A tensor divisor: on CUDA, torch computes `tensor / python_scalar` as a
    # multiply by the reciprocal, which can move the scale by an ulp.
    return amax / torch.full_like(amax, qmax)


def _codes(x, s, qmax: float):
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x.float() / s[..., None, :, None]), -qmax, qmax)


def quantize_int8(x):
    s = quant_scales(x, INT8_MAX)
    return _codes(x, s, INT8_MAX).to(torch.int8), s


def dequantize_int8(q, s, dtype=torch.bfloat16):
    return (q.float() * s[..., None, :, None]).to(dtype)


def pack_int4(q):
    """int8 values in [-8, 7], (..., D) with even D -> (..., D//2) packed, the
    even index in the low nibble."""
    q = q.to(torch.int32)
    v = (q[..., 0::2] & 0x0F) | ((q[..., 1::2] & 0x0F) << 4)
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def unpack_int4(p):
    """(..., D//2) packed -> (..., D) sign-extended int8 in [-8, 7]."""
    lo = ((p & 0x0F) ^ 0x08) - 0x08  # sign-extend the low nibble
    hi = p >> 4  # arithmetic shift sign-extends the high nibble
    d2 = p.shape[-1]
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], 2 * d2).to(torch.int8)


def quantize_int4(x):
    s = quant_scales(x, INT4_MAX)
    return pack_int4(_codes(x, s, INT4_MAX).to(torch.int8)), s


def dequantize_int4(p, s, dtype=torch.bfloat16):
    return (unpack_int4(p).float() * s[..., None, :, None]).to(dtype)


def quant_error(x, tier: int):
    """Relative RMS dequantization error of storing x at ``tier`` (the
    Layer-B analogue of RBER). Returns per-(..., H) float32."""
    x32 = x.float()
    if tier == modes.TIER_BF16:
        return torch.zeros(x.shape[:-3] + (x.shape[-2],), dtype=torch.float32, device=x.device)
    if tier == modes.TIER_INT8:
        q, s = quantize_int8(x)
        xd = dequantize_int8(q, s, torch.float32)
    else:
        q, s = quantize_int4(x)
        xd = dequantize_int4(q, s, torch.float32)
    num = torch.sqrt(torch.mean((x32 - xd) ** 2, dim=(-3, -1)))
    den = torch.sqrt(torch.mean(x32**2, dim=(-3, -1))) + 1e-8
    return num / den
