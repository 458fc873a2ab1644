"""Assigned input-shape set, one per cell of the dry-run matrix (counterpart
of ``repro.configs.shapes``)."""

from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

# long_500k requires sub-quadratic sequence mixing: only the SSM and hybrid
# archs run it; pure full-attention archs skip it with this rationale.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(arch_family: str, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch_family not in SUBQUADRATIC_FAMILIES:
        return False, "long_500k needs sub-quadratic attention; arch is pure full-attention"
    return True, ""
