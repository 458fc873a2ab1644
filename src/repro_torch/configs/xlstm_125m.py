"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (every 4th sLSTM)
[arXiv:2405.04517]. Attention-free: RARO KV tiering inapplicable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, ssm_kind="xlstm", slstm_every=4, expand=2,
)
