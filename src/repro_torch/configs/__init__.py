"""Architecture registry: the configs ported so far (see ROADMAP.md)."""
from repro_torch.configs import tinyllama_1_1b
from repro_torch.configs.base import ModelConfig, smoke_variant

ARCHS = {m.CONFIG.arch: m.CONFIG for m in (tinyllama_1_1b,)}

__all__ = ["ARCHS", "ModelConfig", "smoke_variant"]
