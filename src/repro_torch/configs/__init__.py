"""Architecture registry: the configs ported so far (see ROADMAP.md)."""
from repro_torch.configs import (
    deepseek_7b, deepseek_v3_671b, granite_moe_3b_a800m, internvl2_76b, qwen1_5_110b,
    tinyllama_1_1b, yi_6b,
)
from repro_torch.configs.base import ModelConfig, smoke_variant

ARCHS = {
    m.CONFIG.arch: m.CONFIG
    for m in (deepseek_7b, qwen1_5_110b, yi_6b, tinyllama_1_1b, granite_moe_3b_a800m,
              internvl2_76b, deepseek_v3_671b)
}

__all__ = ["ARCHS", "ModelConfig", "smoke_variant"]
