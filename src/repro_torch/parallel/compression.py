"""Gradient compression with error feedback (counterpart of
``repro.parallel.compression``).

int8 symmetric quantization per tensor; the quantization residual is kept
locally and added to the next step's gradient (error feedback), so the
compressed SGD trajectory tracks the exact one (Karimireddy et al., 2019).
``compressed_allreduce`` is the building block over a mesh axis: all-gather
the int8 payload + scales (4x fewer bytes on the wire than f32),
dequantize-and-sum locally. As in the reference, no training step calls it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import get_mesh
from repro_torch.models import base


def compress(x, err):
    """-> (q int8, scale f32 0-dim, new_err). err may be None."""
    x32 = x.float()
    if err is not None:
        x32 = x32 + err
    amax = torch.clamp(torch.amax(torch.abs(x32)), min=1e-12)
    # a tensor divisor: on CUDA, torch computes `tensor / python_scalar` as a
    # multiply by the reciprocal
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    new_err = x32 - q.float() * scale
    return q, scale, new_err


def decompress(q, scale):
    return q.float() * scale


def compress_tree(grads, err_tree):
    """Tree-mapped compress. err_tree may be None on the first step.
    Returns three trees of grads' structure: codes, scales, residuals."""
    leaves = base.tree_leaves(grads)
    errs = base.tree_leaves(err_tree) if err_tree is not None else [None] * len(leaves)
    out = [compress(g, e) for g, e in zip(leaves, errs)]
    return tuple(base.tree_unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(qs, scales):
    return base.tree_unflatten(qs, [decompress(q, s) for q, s in
                                    zip(base.tree_leaves(qs), base.tree_leaves(scales))])


def compressed_allreduce(x, err, axis: str):
    """Mean-allreduce of ``x`` over ``axis`` of the ambient mesh
    (``launch.mesh.set_mesh``, as the reference's runs inside its
    ``shard_map``), sending the int8 codes and their scale instead of f32.
    Returns (mean, new_err)."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("compressed_allreduce needs an ambient mesh (launch.mesh.set_mesh)")
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    q, scale, new_err = compress(x, err)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)

    qg = gather(q.contiguous())  # int8 on the wire
    sg = gather(scale.reshape(1))[:, 0]
    total = torch.tensordot(sg, qg.float(), dims=([0], [0]))
    return total / torch.full_like(sg[0], n), new_err
