"""whisper-medium [audio] — enc-dec, conv frontend STUB (the batch's "frames"
supplies precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-medium", family="encdec", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab=51865, n_enc_layers=24, enc_len=1500,
    norm="layernorm", act="gelu",
)
