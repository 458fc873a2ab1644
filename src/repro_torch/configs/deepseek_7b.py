"""deepseek-7b [dense] — llama-arch, MHA (GQA kv=32) [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-7b", family="dense", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab=102400,
)
