"""internvl2-76b [vlm] — InternViT frontend STUB (precomputed patch
embeddings) + LLaMA-3-70B-style backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-76b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab=128256, n_img_tokens=256,
)
