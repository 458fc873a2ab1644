"""Meshes (counterpart of ``repro.launch.mesh``).

The reference's production meshes are 16x16 and 2x16x16 TPU chips. One
process cannot hold 256 CUDA devices, so here they are abstract: an axis
layout with sizes and no devices, which the sharding rules and the dry run
read. The mesh the port really runs on is ``make_host_mesh``'s 1x1 over one
card. Functions, not module-level meshes, as in the reference: importing
this module touches no device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Named axes of given sizes, outermost first; ``device`` is the device
    of a mesh that runs (None for an abstract one)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod (abstract)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """The 1x1 ("data", "model") mesh over one card, or over the CPU when
    ``device="cpu"``; no ``device`` means CUDA."""
    return Mesh(("data", "model"), (1, 1), resolve_device(device))
