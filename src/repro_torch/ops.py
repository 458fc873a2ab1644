"""PyTorch stand-ins for the JAX primitives the simulator is written in:
``.at[].set/add/min/max(mode="drop")`` scatters, ``jax.ops.segment_*``
reductions and ``lax.top_k``.

Each keeps the reference's semantics where torch's own op would differ:

- a dropped lane (an index outside ``[0, n)`` after negative indices wrap,
  as JAX wraps them) is written to a trailing row that is sliced off, so no
  boolean mask is taken (on a card a mask's ``nonzero`` makes the host wait);
- float segment sums add through a one-hot mask and ``.sum(0)``: on CUDA,
  ``index_add_`` on floats adds with atomics in an order that changes from
  run to run. Integer sums and every min and max are exact in any order, so
  they use ``index_add_`` and ``scatter_reduce_``;
- a float scatter-add whose lanes must add in lane order, as the
  reference's do (``at_add_in_order``, and two at once in one launch,
  ``at_add_in_order_pair``), runs the ``ordered_scatter_add`` kernel on CUDA;
- ``top_k`` breaks ties to the lowest index, as ``lax.top_k`` does, by a
  stable descending sort: ``torch.topk`` promises no order among ties.

Every function returns a new tensor and leaves its inputs as they were.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ordered_scatter_add.ordered_scatter_add import (
    ordered_scatter_add, ordered_scatter_add_pair)


def recip32(c: float) -> float:
    """The float32 reciprocal of a constant: the reference's compiled
    program turns every division by a constant into a multiply by it (as
    torch on CUDA does for ``tensor / python_scalar``, where the CPU
    divides), so the port multiplies by it on every device."""
    return float(np.float32(1.0) / np.float32(c))


def fma32(a, b, c):
    """``a * b + c`` in float32 with one rounding, as the reference's
    compiled program computes a multiply feeding an add (it fuses them into
    an FMA): taken through float64, where the float32 product is exact."""
    a = torch.as_tensor(a).double()
    return (a * b + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def scalar(value, dtype, device) -> torch.Tensor:
    """A number or a tensor as a 0-dim tensor of ``dtype`` on ``device``; a
    number is filled on the device, where a host tensor would be a copy the
    host waits on."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def index0(x, i):
    """``x[i]`` for a 0-dim integer tensor ``i``, on the device: PyTorch's
    indexing reads a 0-dim integer index back to the host as a Python int,
    which makes the host wait for the card; a one-element index does not."""
    return x[i.reshape(1).long()].reshape(x.shape[1:])


def drop_index(idx, n: int) -> torch.Tensor:
    """``idx`` as a long tensor with negative entries wrapped by ``n`` and
    every entry outside ``[0, n)`` sent to ``n``, the dropped row."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _extended(dst):
    return torch.cat([dst, dst.new_zeros((1, *dst.shape[1:]))])


def _rows(src, idx, dst, row=None):
    """``src`` broadcast to one row of ``dst`` (of shape ``row``, by default
    dst's trailing dims) per index, flattened."""
    row = dst.shape[1:] if row is None else row
    if isinstance(src, torch.Tensor):
        src = src.to(dst.dtype)
    else:  # filled on the device: a host scalar would be a copy the host waits on
        src = torch.full((), src, dtype=dst.dtype, device=dst.device)
    return src.broadcast_to((*idx.shape, *row)).reshape(-1, *row)


def at_set(dst, idx, src):
    """``dst.at[idx].set(src, mode="drop")`` along dim 0. The kept indices
    must be unique (the reference's scatter discipline): which of two equal
    indices wins is not defined in either framework."""
    n = dst.shape[0]
    i = drop_index(idx, n).reshape(-1)
    ext = _extended(dst)
    if isinstance(src, torch.Tensor):
        ext[i] = _rows(src, idx, dst)
    else:  # a Python scalar given as an index value is copied to the card first
        ext.index_fill_(0, i, src)
    return ext[:n]


def at_add(dst, idx, src):
    """``dst.at[idx].add(src, mode="drop")`` along dim 0 (duplicates add).
    Exact for integers; for floats exact only when the added values commute
    exactly (all equal, or integer-valued below 2**24)."""
    n = dst.shape[0]
    i = drop_index(idx, n).reshape(-1)
    return _extended(dst).index_add_(0, i, _rows(src, idx, dst))[:n]


def at_add_in_order(dst, idx, src):
    """``dst.at[idx].add(src, mode="drop")`` along dim 0 for float32 lanes of
    unequal size: each lane is added into ``dst``'s running value one after
    another in lane order, as the reference's scatter-add adds them, so its
    float result bit for bit. On CUDA by the ``ordered_scatter_add`` kernel
    (``index_add_``'s atomic adds there take no fixed order); on the CPU by
    its plain version, ``index_add_``, which runs serially there."""
    n = dst.shape[0]
    return ordered_scatter_add(dst.contiguous(), drop_index(idx, n).reshape(-1),
                               _rows(src, idx, dst).contiguous())


def at_add_in_order_pair(a, b):
    """Two ``at_add_in_order``s, each of ``a`` and ``b`` a (dst, idx, src), in
    one ``ordered_scatter_add`` launch on CUDA. A dst's rows are all its dims
    but the last, flattened in order (at most two, at any strides), so that
    a state leaf is read and written in its own layout; each result has its
    dst's shape and strides."""
    segs = []
    for dst, idx, src in (a, b):
        n = dst.numel() // max(dst.shape[-1], 1)
        segs.append((dst, drop_index(idx, n).reshape(-1),
                     _rows(src, idx, dst, dst.shape[-1:]).contiguous()))
    return ordered_scatter_add_pair(*segs)


def _at_reduce(dst, idx, src, how):
    n = dst.shape[0]
    i = drop_index(idx, n).reshape(-1)
    return _extended(dst).scatter_reduce_(0, i, _rows(src, idx, dst), how,
                                          include_self=True)[:n]


def at_min(dst, idx, src):
    """``dst.at[idx].min(src, mode="drop")`` for a 1-D ``dst``."""
    return _at_reduce(dst, idx, src, "amin")


def at_max(dst, idx, src):
    """``dst.at[idx].max(src, mode="drop")`` for a 1-D ``dst``."""
    return _at_reduce(dst, idx, src, "amax")


def segment_sum(data, seg, n: int):
    """``jax.ops.segment_sum(data, seg, num_segments=n)`` over 1-D lanes
    (``data`` may carry trailing feature dims); the dtype is kept."""
    if data.dtype.is_floating_point:
        onehot = seg.reshape(-1, 1) == torch.arange(n, device=seg.device)
        onehot = onehot.reshape(*onehot.shape, *([1] * (data.dim() - 1)))
        return torch.where(onehot, data.reshape(-1, 1, *data.shape[1:]), 0.0).sum(0)
    out = data.new_zeros((n, *data.shape[1:]))
    return at_add(out, seg, data)


def _segment_reduce(data, seg, n, how):
    dt = data.dtype
    if dt.is_floating_point:
        init = -torch.inf if how == "amax" else torch.inf
    else:
        info = torch.iinfo(dt)
        init = info.min if how == "amax" else info.max
    return _at_reduce(torch.full((n,), init, dtype=dt, device=data.device), seg, data, how)


def segment_max(data, seg, n: int):
    """``jax.ops.segment_max``: an empty segment holds the dtype's lowest value."""
    return _segment_reduce(data, seg, n, "amax")


def segment_min(data, seg, n: int):
    """``jax.ops.segment_min``: an empty segment holds the dtype's highest value."""
    return _segment_reduce(data, seg, n, "amin")


def top_k(x, k: int):
    """``lax.top_k`` along the last dim: values and int32 indices, ties to the
    lowest index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)
