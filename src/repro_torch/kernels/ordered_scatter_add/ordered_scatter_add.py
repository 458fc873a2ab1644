"""Scatter-add in lane order: the observability instruments' float sums.

No Pallas kernel stands behind it. The reference adds each read's values
into its float accumulators with ``.at[idx].add(src, mode="drop")``
(``repro.ssdsim.obs.record_reads``), which adds the lanes one after another
in lane order; PyTorch's scatter-adds on CUDA (``index_add_``,
``index_put_(accumulate=True)``) use atomics and take no fixed order. The
kernel is ``csrc/ordered_scatter_add.cu``: CUDA tensors go to it, CPU
tensors to the plain version, ``index_add_``, which adds serially on the
CPU and so equals the reference bit for bit.

Two entries, one kernel: ``ordered_scatter_add`` takes one (dst, idx, src)
segment; ``ordered_scatter_add_pair`` takes two in one launch (a chunk's
time series and component sums), each dst read and written through its own
strides, so that a state leaf is taken in its own layout.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_COLUMNS = 128  # a row's elements: four a thread of the row's warp
_fns = {}


def _kernel():
    if "launch" not in _fns:
        fn = build.load("ordered_scatter_add").ordered_scatter_add_launch
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["launch"] = fn
    return _fns["launch"]


def ordered_scatter_add_plain(dst, idx, src):
    """The plain version: ``dst`` with ``src``'s rows added at ``idx`` by
    ``index_add_`` into a copy with one more row, which takes the dropped
    lanes. Serial, in lane order, on the CPU; on CUDA in no fixed order."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1, *dst.shape[1:]))])
    return ext.index_add_(0, torch.where((idx >= 0) & (idx < n), idx, n), src)[:n]


def ordered_scatter_add_pair_plain(a, b):
    """The plain version of the pair: ``ordered_scatter_add_plain`` on each
    segment's rows (all of dst's dims but the last, flattened), the result
    in dst's shape and strides."""
    outs = []
    for dst, idx, src in (a, b):
        rows = ordered_scatter_add_plain(dst.reshape(-1, dst.shape[-1]), idx, src)
        outs.append(torch.empty_like(dst).copy_(rows.reshape(dst.shape)))
    return tuple(outs)


def _segment(dst, idx, src, out, name):
    """The kernel's int64 arguments of one segment, its inputs checked. dst
    and out are (N, C) or (G, R, C) at any strides (rows: the leading dims
    in order); idx (L,) int64; src (L, C) contiguous."""
    if dst.dtype != torch.float32 or src.dtype != torch.float32 or idx.dtype != torch.int64:
        raise ValueError(f"{name}: dst and src must be float32 and idx int64, got {dst.dtype}, "
                         f"{src.dtype} and {idx.dtype}")
    if dst.dim() not in (2, 3) or idx.dim() != 1 or src.shape != (idx.shape[0], dst.shape[-1]):
        raise ValueError(f"{name}: need dst (N, C) or (G, R, C), idx (L,) and src (L, C), got "
                         f"{tuple(dst.shape)}, {tuple(idx.shape)} and {tuple(src.shape)}")
    for what, t in (("idx", idx), ("src", src)):
        if t.device != dst.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on {dst.device}")
    if max(dst.numel(), src.numel()) >= 2**31:
        raise ValueError(f"{name}: the kernel counts elements with 32-bit integers")
    if dst.shape[-1] > MAX_COLUMNS:
        raise ValueError(f"{name}: the kernel takes rows of at most {MAX_COLUMNS} elements, got "
                         f"{dst.shape[-1]}")
    groups, rows = (1, dst.shape[0]) if dst.dim() == 2 else dst.shape[:2]
    group_stride = 0 if dst.dim() == 2 else dst.stride(0)
    return [dst.data_ptr(), out.data_ptr(), idx.data_ptr(), src.data_ptr(), groups * rows,
            dst.shape[-1], idx.shape[0], rows, group_stride, *dst.stride()[-2:]]


def _launch(segments):
    """One kernel launch over the (dst, idx, src) segments, each dst on the
    same card and non-empty; returns each segment's out, shaped and strided
    as its dst."""
    dev = segments[0][0].device
    outs, args = [], []
    for i, (dst, idx, src) in enumerate(segments):
        if dst.device != dev:
            raise ValueError(f"segment {i}: dst on {dst.device}, the first on {dev}")
        out = torch.empty_like(dst)  # dst's strides where dst is dense without overlaps
        if out.stride() != dst.stride():
            raise ValueError(f"segment {i}: dst must be dense without overlaps")
        args += _segment(dst, idx, src, out, f"segment {i}")
        outs.append(out)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(len(segments), (ctypes.c_longlong * len(args))(*args),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ordered_scatter_add kernel launch failed: CUDA error {rc}")
    ordered_scatter_add.launches += 1
    return outs


def _on_cuda(t):
    """True for a CUDA tensor, False for a CPU one; raises for other devices."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ordered_scatter_add runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def ordered_scatter_add(dst, idx, src):
    """``dst.at[idx].add(src, mode="drop")`` along dim 0, adding each lane into
    the running value of its row in lane order. dst: (N, ...) float32, at
    most MAX_COLUMNS elements a row on CUDA; idx:
    (L,) int64, entries outside [0, N) dropped; src: (L, ...) float32 rows of
    dst's trailing shape. Returns a new tensor; ``dst`` is left as it was.
    ``ordered_scatter_add.launches`` counts launches of the kernel."""
    if not _on_cuda(dst):
        return ordered_scatter_add_plain(dst, idx, src)
    if dst.dim() < 1 or idx.dim() != 1 or src.shape != (idx.shape[0], *dst.shape[1:]):
        raise ValueError(f"need dst (N, ...), idx (L,) and src (L, ...) of dst's rows, got "
                         f"{tuple(dst.shape)}, {tuple(idx.shape)} and {tuple(src.shape)}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError(f"dst and src must be contiguous on {dst.device}")
    if dst.numel() == 0:
        return torch.empty_like(dst)
    n = dst.shape[0]
    c = dst.numel() // n
    (out,) = _launch([(dst.view(n, c), idx, src.view(idx.shape[0], c))])
    return out.view(dst.shape)


def ordered_scatter_add_pair(a, b):
    """Two ``ordered_scatter_add``s in one kernel launch on CUDA: each of
    ``a`` and ``b`` a (dst, idx, src), whose dst is (N, C) or (G, R, C) at
    any strides (the rows: its leading dims, flattened in order; dense, no
    overlaps), idx (L,) int64 naming rows (outside [0, rows) dropped), src
    (L, C) float32. Returns the two results, each shaped and strided as its
    dst; the inputs are left as they were. One launch counted, whatever the
    number of segments it carries."""
    if not _on_cuda(a[0]):
        return ordered_scatter_add_pair_plain(a, b)
    for dst in (a[0], b[0]):
        if dst.dim() not in (2, 3):
            raise ValueError(f"need dst (N, C) or (G, R, C), got {tuple(dst.shape)}")
    keep = [s for s in (a, b) if s[0].numel()]
    outs = iter(_launch(keep) if keep else [])
    return tuple(next(outs) if s[0].numel() else torch.empty_like(s[0]) for s in (a, b))


ordered_scatter_add.launches = 0
