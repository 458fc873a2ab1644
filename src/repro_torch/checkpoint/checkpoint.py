"""Atomic, optionally asynchronous checkpoints (counterpart of
``repro.checkpoint.checkpoint``), in the reference's on-disk format.

A checkpoint directory holds ``arrays.npz`` (one array per leaf, keyed by
its dotted path in the tree) and ``manifest.json`` (step, extra, each
leaf's shape and dtype). bfloat16 leaves are stored as their uint16 bits
and tagged ``bfloat16`` in the manifest. The directory is written under a
``.tmp`` name and becomes visible by one rename, so a crash mid-save never
leaves a checkpoint that ``restore`` would read. A tree in the reference's
layout (``convert.stack_layers``) gives the reference's files: either
package restores the other's checkpoints.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.base import tree_paths


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if hasattr(tree, "_asdict"):
        return tree._asdict().items()
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def _rebuild(tree, leaf, prefix=""):
    """``tree``'s structure with each leaf replaced by ``leaf(path, old)``."""
    items = _items(tree)
    if items is None:
        return leaf(prefix.rstrip("."), tree)
    out = {k: _rebuild(v, leaf, f"{prefix}{k}.") for k, v in items}
    if isinstance(tree, dict):
        return out
    if hasattr(tree, "_fields"):
        return type(tree)(**out)
    return type(tree)(out.values())


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (never a view of a tensor that may change later)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(path: str | Path, tree, *, step: int, extra: dict | None = None,
         async_: bool = False):
    """Write a checkpoint of ``tree`` (tensors) at ``path``, atomically.

    The leaves are copied to the host first; with ``async_`` the files are
    then written on a thread. Returns a callable that waits for the write.
    """
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = tree_paths(tree)
    host = {k: _to_host(v) for k, v in flat.items()}
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {k: {"shape": list(flat[k].shape),
                       "dtype": str(flat[k].dtype).removeprefix("torch.")} for k in flat},
    }

    def _write():
        np.savez(tmp / "arrays.npz", **host)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)

    if async_:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        return th.join
    _write()
    return lambda: None


def restore(path: str | Path, like_tree, *, device=None):
    """Restore into the structure, shapes and dtypes of ``like_tree``, on
    ``device`` (CUDA unless the caller names one). Returns (tree, manifest).
    Raises ValueError for a missing leaf or a shape that differs."""
    device = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        missing = [k for k in tree_paths(like_tree) if k not in data.files]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")

        def leaf(key, like):
            arr = data[key]
            if manifest["leaves"][key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(like.shape)}")
            return t.to(device=device, dtype=like.dtype)

        return _rebuild(like_tree, leaf), manifest
