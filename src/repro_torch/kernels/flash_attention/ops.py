"""Public flash-attention entries on the (B, S, H, D) layout (counterpart of
``repro.kernels.flash_attention.ops``).

The reference transposes to (B·H, S, D) and pads S to a block multiple
before its kernel. The port's kernel reads (B, S, H, D) in place through
strides and masks the ragged tail itself, so this wrapper does neither.

``flash_attention`` is forward only (prefill). ``flash_attention_train`` is
the training entry: its forward is the same kernel, and its backward
recomputes the plain attention from q, k and v and takes that function's
vector-Jacobian product. The reference has no backward kernel either: its
training gradients come from the plain blockwise attention.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.models.attention import reference_attention


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the kernel forward, and a backward
    that recomputes ``reference_attention`` (f32 scores, the same function)
    from the saved q, k and v. The recompute lives only inside one call of
    ``backward``, so one layer's score matrix is alive at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*inputs, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, causal: bool = True):
    """Flash attention that autograd differentiates. q: (B, Sq, H, D); k, v:
    (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype."""
    return FlashAttentionFn.apply(q, k, v, causal)
