"""granite-moe-3b-a800m [moe] — 40 experts top-8, GQA kv=8
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=0, vocab=49155, d_head=64,
    n_experts=40, top_k=8, moe_d_ff=512,
)
