"""PyTorch/CUDA port of the RARO reproduction (the JAX package ``repro`` is
the reference it is held against). Laid out module for module like
``repro``; see ROADMAP.md for what is ported so far."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no card and no explicit device this raises instead of running on
    the CPU. On CUDA, float32 matmuls are pinned to full float32 (no TF32),
    since the reference computes in float32.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
