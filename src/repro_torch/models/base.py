"""Parameter-spec infrastructure (counterpart of ``repro.models.base``).

Models declare parameters as nested dicts (and lists, one entry per layer)
of :class:`ParamSpec`; ``materialize`` turns a spec tree into tensors. The
reference's mesh-sharding rules are TPU-mesh code and are not ported (see
ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(f, tree):
    """Apply ``f`` to every leaf of a tree of dicts, lists and tuples
    (NamedTuples keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(f, v) for v in tree]
    if isinstance(tree, tuple):
        out = (tree_map(f, v) for v in tree)
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return f(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts, NamedTuples, lists and tuples,
    in ``tree_leaves`` order ("layers.0.attn.wq"; a checkpoint's array keys)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("."): tree}
    out = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}{k}."))
    return out


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def materialize(specs, generator: torch.Generator, dtype=None, device=None):
    """Instantiate real parameters: normal(0, 0.02), or normal scaled by
    1/sqrt(fan-in) for ``scaled``, drawn in float32 from ``generator`` (which
    must live on ``device``) in the order of the spec tree."""

    def init_one(spec: ParamSpec):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        scale = 1.0
        if spec.init == "scaled" and len(spec.shape) >= 2:
            scale = 1.0 / math.sqrt(spec.shape[-2])
        elif spec.init == "normal":
            scale = 0.02
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * scale).to(dt)

    return tree_map(init_one, specs)


def n_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))
