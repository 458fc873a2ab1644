"""Gradient compression with error feedback (counterpart of
``repro.parallel.compression``).

int8 symmetric quantization per tensor; the quantization residual is kept
locally and added to the next step's gradient (error feedback), so the
compressed SGD trajectory tracks the exact one (Karimireddy et al., 2019).
The reference's ``compressed_allreduce`` gathers the int8 payload over a
mesh axis; it waits for the multi-card slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

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
