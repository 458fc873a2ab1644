"""Public flash-attention entries on the (B, S, H, D) layout (counterpart of
``repro.kernels.flash_attention.ops``).

The reference transposes to (B·H, S, D) and pads S to a block multiple
before its kernel. The port's kernel reads (B, S, H, D) in place through
strides and masks the ragged tail itself, so this wrapper does neither.

``flash_attention`` is forward only (prefill). ``flash_attention_train`` is
the training entry: its forward is the same kernel, which also writes each
row's log-sum-exp, and its backward is the backward kernels
(``flash_attention_bwd.py``), which recompute the probabilities from it. The
reference has no backward kernel: its training gradients are the autodiff of
the plain blockwise attention, the same function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (flash_attention_fwd,
                                                                  flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention.flash_attention_bwd import flash_attention_bwd


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the kernel forward, which saves q, k,
    v, the output and its log-sum-exp (B·H·Sq f32), and the backward kernels
    on them. On the CPU both are the kernels' plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, grad_out, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, causal: bool = True):
    """Flash attention that autograd differentiates. q: (B, Sq, H, D); k, v:
    (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype."""
    return FlashAttentionFn.apply(q, k, v, causal)
