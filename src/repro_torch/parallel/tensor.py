"""Tensor parallelism over a mesh's "model" axis: the port's stand-in for
GSPMD's partitioning of the products, as ``collectives.py`` stands in for
``shard_map``'s collectives.

The reference places each parameter of every family by the sharding rules
(``sharding.param_shardings``) and lets GSPMD split the products that read
it. Here each rank holds its block of every parameter the rules split
(``sharding.shard_params``), and the layers call the products of this module
in Megatron's pattern: a column-parallel product takes the replicated
activation (``collectives.replicated``, whose backward sums the ranks'
partial cotangents) to this rank's block of the output features; a
row-parallel product takes this rank's block of the input features and sums
the ranks' partial outputs (``collectives.psum``). Between the two, the
activation stays split over the features (attention heads, MLP width,
vocabulary columns, a recurrent block's head features).

Some blocks are no unit of independent work: a block that straddles
concatenated segments (mLSTM's ``[u | z]`` up-projection, Mamba2's
``[z | x | B | C | dt]`` in-projection, sLSTM's gate-major ``[i | f | z |
o]``), or a leaf whose split does not follow the recurrence that reads it
(sLSTM's recurrent ``r``, split over heads while each head feeds every
gate). Such a leaf is ``gathered`` at its use (all-gathered, its backward
this rank's block of the replicated cotangent) and that part runs whole on
every rank; the leaf, its gradient and its AdamW moments stay the rank's
block at rest.

A layer learns that a parameter is split from its shape: ``split_group``
compares a dim's local size with the config's whole size and returns the
ambient mesh's "model" group only where they differ. Whole parameters (no
mesh, a model axis of 1, a leaf whose dim the axis does not divide, or the
one-device serving paths) take every function's one-device path unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import get_mesh
from repro_torch.models.layers import matmul
from repro_torch.parallel import collectives as C


def split_group(local: int, whole: int):
    """The ambient mesh's "model" process group where a dim of ``whole``
    entries is held as ``local`` on each rank, None where it is whole."""
    if local == whole:
        return None
    mesh = get_mesh()
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if not hasattr(mesh, "group") or local * tp != whole:
        raise RuntimeError(f"a dim of {whole} held as {local} needs an ambient mesh "
                           f"(launch.mesh.set_mesh) whose model axis is {whole // local}; "
                           f"it is {tp}")
    return mesh.group("model")


def rank(group) -> int:
    """This rank's index along the model axis (its block of every split dim)."""
    return dist.get_rank(group)


def column(x, ws, group):
    """``x @ w`` for each of ``ws``, each split over its output features: the
    replicated ``x`` (one ``replicated``, so one all-reduce of its partial
    cotangents for all of them) to this rank's block of each output."""
    x = C.replicated(x, group)
    return [matmul(x, w) for w in ws]


def gathered(w, dim: int, whole: int):
    """A parameter whole at its use: where ``w`` holds this rank's block of
    its ``dim`` (``whole`` entries in all), the ranks' blocks all-gathered
    (``collectives.unshard``, whose backward keeps this rank's block of the
    replicated cotangent); a whole ``w`` as it is."""
    group = split_group(w.shape[dim], whole)
    return w if group is None else C.unshard(w, group, dim)


def row(x, w, group):
    """``x @ w`` for a ``w`` split over its input features, ``x`` this rank's
    block of them: the ranks' partial products summed, replicated."""
    return C.psum(matmul(x, w), group)


def mlp_group(p, width: int):
    """The "model" group where an MLP of ``width`` (``layers.mlp_specs``) has
    its width split, else None."""
    return split_group(p["w_in"].shape[-1], width)


def head_range(group, h_local: int) -> tuple[int, int]:
    """The global query heads this rank holds: [start, stop)."""
    start = rank(group) * h_local
    return start, start + h_local


def kv_heads_for(group, h_local: int, n_heads: int, n_kv_heads: int):
    """Where the query heads are split and the KV heads are whole, the KV
    heads this rank's queries read, as (first, count) when they are whole
    groups or one head shared by all of them, else the index of one KV head
    for each local query head (the groups straddle the rank's range, as at
    12 heads over 4 KV heads on 6 ranks), for ``index_select``."""
    g = n_heads // n_kv_heads
    start, stop = head_range(group, h_local)
    if h_local % g == 0:
        return start // g, h_local // g
    if g % h_local == 0:
        return start // g, 1
    return torch.arange(start, stop) // g
