"""Serving steps: prefill, then greedy or temperature decode over the model's
KV cache (counterpart of ``repro.serving.serve_step``).

The reference's temperature path draws with a JAX key; this one takes a
``torch.Generator`` on the logits' device. The two draw different tokens
from the same seed; greedy decoding is the same in both.
"""

from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry


def make_prefill(cfg: ModelConfig):
    api = registry.get_api(cfg)

    def prefill(params, batch):
        """batch: {"tokens": (B, S)} -> (next token (B,) int32, cache); one
        ``prefill`` span (``repro_torch.spans``) over it all."""
        with spans.span("prefill"):
            logits, cache = api.prefill(params, batch)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    api = registry.get_api(cfg)

    def serve_step(params, cache, tokens, pos, generator=None):
        """tokens: (B, 1); pos: (B,) -> (next token (B,) int32, cache). Samples
        at ``temperature`` when it is > 0 and a generator is given, else greedy."""
        logits, cache = api.decode_step(params, cache, tokens, pos)
        logits = logits[:, -1].float()
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return next_tok.to(torch.int32), cache

    return serve_step
