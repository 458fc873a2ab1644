"""Wrappers for the page-quantization migration kernel (counterpart of
``repro.kernels.quant_page.ops``)."""

from __future__ import annotations

from repro_torch.kernels.quant_page.quant_page import quant_store_pages, quantize_pages

__all__ = ["quant_pages", "quant_store_pages"]


def quant_pages(x, *, tier: int):
    """x: (N, P, Hk, D) -> (codes, scales (N, Hk), err (N,))."""
    q, s, e = quantize_pages(x, tier=tier)
    return q, s, e[:, 0]
