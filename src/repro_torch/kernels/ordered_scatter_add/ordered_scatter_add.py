"""Scatter-add in lane order: the observability instruments' float sums.

No Pallas kernel stands behind it. The reference adds each read's values
into its float accumulators with ``.at[idx].add(src, mode="drop")``
(``repro.ssdsim.obs.record_reads``), which adds the lanes one after another
in lane order; PyTorch's scatter-adds on CUDA (``index_add_``,
``index_put_(accumulate=True)``) use atomics and take no fixed order. The
kernel is ``csrc/ordered_scatter_add.cu``: CUDA tensors go to it, CPU
tensors to the plain version, ``index_add_``, which adds serially on the
CPU and so equals the reference bit for bit.
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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


def ordered_scatter_add(dst, idx, src):
    """``dst.at[idx].add(src, mode="drop")`` along dim 0, adding each lane into
    the running value of its row in lane order. dst: (N, ...) float32, at
    most MAX_COLUMNS elements a row on CUDA; idx:
    (L,) int64, entries outside [0, N) dropped; src: (L, ...) float32 rows of
    dst's trailing shape. Returns a new tensor; ``dst`` is left as it was.
    ``ordered_scatter_add.launches`` counts launches of the kernel."""
    if dst.device.type == "cpu":
        return ordered_scatter_add_plain(dst, idx, src)
    if dst.device.type != "cuda":
        raise ValueError(f"ordered_scatter_add runs on cuda or cpu, not {dst.device}")
    if dst.dtype != torch.float32 or src.dtype != torch.float32 or idx.dtype != torch.int64:
        raise ValueError(f"dst and src must be float32 and idx int64, got {dst.dtype}, "
                         f"{src.dtype} and {idx.dtype}")
    if dst.dim() < 1 or idx.dim() != 1 or src.shape != (idx.shape[0], *dst.shape[1:]):
        raise ValueError(f"need dst (N, ...), idx (L,) and src (L, ...) of dst's rows, got "
                         f"{tuple(dst.shape)}, {tuple(idx.shape)} and {tuple(src.shape)}")
    for name, t in (("dst", dst), ("idx", idx), ("src", src)):
        if t.device != dst.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dst.device}")
    if max(dst.numel(), src.numel()) >= 2**31:
        raise ValueError("the kernel counts elements with 32-bit integers")
    if dst.shape[0] and dst.numel() // dst.shape[0] > MAX_COLUMNS:
        raise ValueError(f"the kernel takes rows of at most {MAX_COLUMNS} elements, got "
                         f"{tuple(dst.shape[1:])}")
    out = torch.empty_like(dst)
    if dst.numel() == 0:
        return out
    n, lanes = dst.shape[0], idx.shape[0]
    fn = _kernel()
    with torch.cuda.device(dst.device):
        rc = fn(dst.data_ptr(), idx.data_ptr(), src.data_ptr(), out.data_ptr(), n,
                dst.numel() // n, lanes, torch.cuda.current_stream(dst.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ordered_scatter_add kernel launch failed: CUDA error {rc}")
    ordered_scatter_add.launches += 1
    return out


ordered_scatter_add.launches = 0
