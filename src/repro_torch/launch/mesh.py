"""Meshes (counterpart of ``repro.launch.mesh``, with the runtime half of
``jax.make_mesh``, ``jax.set_mesh`` and ``jax.sharding.get_abstract_mesh``).

The reference's production meshes are 16x16 and 2x16x16 TPU chips. One
process cannot hold 256 CUDA devices, so here they are abstract: an axis
layout with sizes and no devices, which the sharding rules and the dry run
read. ``make_host_mesh`` is the 1x1 layout over one card.

A mesh that runs is a :class:`ProcessMesh` (``make_mesh``): one process per
device, joined by ``torch.distributed`` (``init_distributed``; NCCL on CUDA,
gloo on the CPU), each axis a process group. ``set_mesh`` makes a mesh the
ambient one that ``get_mesh`` returns, as ``jax.set_mesh`` does for the
reference's ``_ambient_mesh``. Functions, not module-level meshes, as in the
reference: importing this module touches no device and starts no group.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

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


@dataclass(frozen=True, eq=False)
class ProcessMesh(Mesh):
    """A mesh that runs: this process is one of its ``size`` ranks, on
    ``device``. ``device_mesh`` is the ``torch.distributed`` DeviceMesh whose
    dims are the axes; ``data_group`` joins the ranks that differ only along
    the data axes (``pod`` and ``data``), over which gradients are averaged."""
    device_mesh: object = None
    data_group: object = None

    def group(self, axis: str):
        """The process group along ``axis`` that holds this rank."""
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def init_distributed(device=None, init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, backend: str | None = None) -> torch.device:
    """Join the default process group (the counterpart of the devices that
    ``jax.devices()`` lists) and return this process's device: CUDA unless the
    caller names one (NCCL; ``cuda:LOCAL_RANK`` when no index is given), or
    the CPU (gloo). ``rank`` and ``world_size`` default to the launcher's
    ``RANK`` and ``WORLD_SIZE``, and ``init_method`` to ``env://``
    (``MASTER_ADDR`` and ``MASTER_PORT``), as ``torchrun`` sets them.
    ``backend="gloo"`` on CUDA lets several ranks share one card, which NCCL
    refuses: gloo's all-reduce and all-gather take CUDA tensors through the
    host. A group already started is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://",
                                rank=-1 if rank is None else rank,
                                world_size=-1 if world_size is None else world_size)
    return dev


def make_mesh(axis_sizes, axis_names, device=None) -> ProcessMesh:
    """A mesh of ``axis_sizes`` named ``axis_names`` (outermost first) over
    the default process group, whose world size must be their product; rank
    r sits at r's row-major coordinates. ``device`` as ``init_distributed``
    takes it (the group must have been started on its kind)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
    world = dist.get_world_size()
    if math.prod(axis_sizes) != world:
        raise ValueError(f"a {axis_sizes} mesh needs {math.prod(axis_sizes)} ranks; "
                         f"the group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(dev.type, axis_sizes, mesh_dim_names=axis_names)
    data = tuple(a for a in axis_names if a != "model")
    if len(data) == 1:
        data_group = dm.get_group(data[0])
    else:  # the data axes together: one group per coordinate of the others
        ranks = torch.arange(world).reshape(axis_sizes)
        keep = [i for i, a in enumerate(axis_names) if a not in data]
        ranks = ranks.permute(*keep, *[i for i in range(len(axis_names)) if i not in keep])
        data_group, _ = dist.new_subgroups_by_enumeration(
            ranks.reshape(-1, math.prod(axis_sizes[axis_names.index(a)] for a in data)).tolist())
    return ProcessMesh(axis_names, axis_sizes, dev, dm, data_group)


_AMBIENT: list = []  # the meshes set_mesh has entered, innermost last


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the one ``get_mesh`` returns inside the block (the
    counterpart of ``jax.set_mesh``). Kept in the module, not in a
    ``contextvars`` variable: on CUDA the backward runs in autograd's own
    thread, and remat recomputes each layer's forward there, where it must
    take the same dispatch as the forward did."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_mesh():
    """The innermost mesh that ``set_mesh`` made ambient, or None."""
    return _AMBIENT[-1] if _AMBIENT else None
