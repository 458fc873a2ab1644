"""Plain oracle for the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ref``)."""

from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal: bool = True):
    return reference_attention(q, k, v, causal=causal)
