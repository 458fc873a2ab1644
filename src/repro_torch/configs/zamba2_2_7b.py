"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every 9
layers, ssm_state=64 [arXiv:2411.15242]. Sliding-window (4096) attention
keeps long_500k sub-quadratic."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab=32000, d_state=64, attn_every=9,
    window=4096, expand=2,
)
