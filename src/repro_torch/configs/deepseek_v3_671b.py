"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]. d_ff=2048 is the routed-expert width; the first 3
layers are dense (width 18432, per the paper)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, d_ff=18432, vocab=129280,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1, first_k_dense=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    nope_head_dim=128, v_head_dim=128, mtp_depth=1,
)
