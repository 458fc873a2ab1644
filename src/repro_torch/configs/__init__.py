"""Architecture registry: --arch <id> selects one of these configs (the
reference's ten)."""
from repro_torch.configs import (
    deepseek_7b, deepseek_v3_671b, granite_moe_3b_a800m, internvl2_76b, qwen1_5_110b,
    tinyllama_1_1b, whisper_medium, xlstm_125m, yi_6b, zamba2_2_7b,
)
from repro_torch.configs.base import ModelConfig, ShapeConfig, smoke_variant
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, applicable

ARCHS = {
    m.CONFIG.arch: m.CONFIG
    for m in (deepseek_7b, qwen1_5_110b, yi_6b, tinyllama_1_1b, deepseek_v3_671b,
              granite_moe_3b_a800m, whisper_medium, xlstm_125m, internvl2_76b, zamba2_2_7b)
}

__all__ = ["ARCHS", "SHAPES", "ALL_SHAPES", "ModelConfig", "ShapeConfig", "smoke_variant",
           "applicable"]
