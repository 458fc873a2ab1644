"""Public flash-attention entry on the (B, S, H, D) layout (counterpart of
``repro.kernels.flash_attention.ops``).

The reference transposes to (B·H, S, D) and pads S to a block multiple
before its kernel. The port's kernel reads (B, S, H, D) in place through
strides and masks the ragged tail itself, so this wrapper does neither.
Forward only: the reference defines no custom VJP either.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) -> (B, Sq, H, D) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
