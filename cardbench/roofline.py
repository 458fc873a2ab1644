"""The yardstick: one H100's published peaks, and the operations and bytes
of each flash-attention call and of each whole step, from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the
full 700 W power limit). A flash call's bound counts each input byte read
once and each output byte written once; its operations are 2 per
multiply-add of each product over the (query, key) pairs the causal mask
keeps. A step's model operations count what the model needs: the
parameters each token passes through (the experts it is routed to, not the
capacity's padding) and attention's pairs; remat's recomputation is not
counted, and a prefill's head runs at the last position only.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}  # f32: 3xTF32 tensor cores
BYTES = {"bfloat16": 2, "float32": 4}


def causal_pairs(sq: int, sk: int) -> int:
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def flash_fwd(b, sq, sk, h, hk, d, dv, dtype: str, lse: bool = False):
    """(operations, bytes) of one causal forward call: q, k, v read, o
    written (and, for the training entry, the f32 log-sum-exp)."""
    e = BYTES[dtype]
    byt = (b * sq * h * d + 2 * b * sk * hk * d + b * sq * h * dv) * e
    if lse:
        byt += b * h * sq * 4
    return 2 * (d + dv) * b * h * causal_pairs(sq, sk), byt


def flash_bwd(b, sq, sk, h, hk, d, dv, dtype: str):
    """(operations, bytes) of one causal backward call: q, k, v, o, dO and
    the log-sum-exp read, dq, dk, dv written; five products a kept pair."""
    e = BYTES[dtype]
    q, kv, o = b * sq * h * d, b * sk * hk * d, b * sq * h * dv
    byt = (2 * (q + 2 * kv) + 2 * o) * e + b * h * sq * 4
    return 2 * (3 * d + 2 * dv) * b * h * causal_pairs(sq, sk), byt


def bound_s(ops: float, byt: float, dtype: str) -> float:
    return max(ops / PEAK_FLOP_PER_S[dtype], byt / HBM_BYTES_PER_S)


def _layer_params(c: dict) -> tuple[int, int]:
    """(parameters a token passes through in one layer's products, the
    layer's attention heads' width d + dv per head times heads)."""
    d, h, hk = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    dh = d // h
    attn = 2 * d * h * dh + 2 * d * hk * dh
    f = c["intermediate_size"]
    if c.get("num_local_experts", 0):
        ffn = d * c["num_local_experts"] + c["num_experts_per_tok"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return attn + ffn, 2 * h * dh


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    """Model operations of one training step: 6 per parameter a token passes
    through (forward and backward), the head over every position, and
    attention's products over the causal pairs, 3 times the forward's."""
    per_layer, heads_width = _layer_params(c)
    tokens = batch * seq
    n = c["num_hidden_layers"] * per_layer + c["vocab_size"] * c["hidden_size"]
    attn = c["num_hidden_layers"] * 2 * heads_width * batch * causal_pairs(seq, seq)
    return 6.0 * n * tokens + 3.0 * attn


def prefill_flops(c: dict, length: int) -> float:
    """Model operations of one prompt's prefill: 2 per parameter a token
    passes through, the head at the last position, attention's products."""
    per_layer, heads_width = _layer_params(c)
    layers = c["num_hidden_layers"]
    return (2.0 * layers * per_layer * length + 2.0 * c["vocab_size"] * c["hidden_size"]
            + layers * 2 * heads_width * causal_pairs(length, length))
