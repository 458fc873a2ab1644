"""Model and shape configuration dataclasses (counterpart of
``repro.configs.base``)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MTP (DeepSeek-V3 multi-token prediction) ---
    mtp_depth: int = 0
    mtp_loss_coef: float = 0.3
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 1500
    # --- SSM ---
    ssm_kind: str = ""  # xlstm | mamba2
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    slstm_every: int = 0
    # --- hybrid (zamba2) ---
    attn_every: int = 0
    window: int = 0
    # --- VLM stub frontend ---
    n_img_tokens: int = 0
    # --- compute knobs ---
    dtype: Any = torch.bfloat16
    remat: bool = True
    kv_bits: int = 16  # 16 | 8 | 4 — RARO dense-tier KV cache for decode
    xent_chunk: int = 0
    moe_hints: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        dtype=torch.float32,
        remat=False,
    )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=2, moe_d_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.mla:
        kw.update(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_len=32)
    if cfg.ssm_kind:
        kw.update(d_state=16, d_conv=4, expand=2)
    if cfg.slstm_every:
        kw.update(slstm_every=2)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.window:
        kw.update(window=64)
    if cfg.n_img_tokens:
        kw.update(n_img_tokens=16)
    return cfg.with_(**kw)
