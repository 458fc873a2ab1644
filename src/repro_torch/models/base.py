"""Parameter-spec infrastructure (counterpart of ``repro.models.base``).

Models declare parameters as nested dicts (and lists, one entry per layer)
of :class:`ParamSpec`. From one spec tree come:

  * real parameters      (``materialize``)
  * abstract parameters  (``abstract``: tensors on the meta device, which the
                          dry run steps through without allocating a byte)
  * shardings            (``param_pspecs`` / ``param_shardings``: logical axes
                          to mesh axes by one rule table, ``DEFAULT_RULES``)

A :class:`PartitionSpec` names, for each tensor dim, the mesh axis (or tuple
of axes) it is split over, or ``None``; a :class:`NamedSharding` pairs one
with a mesh and gives the per-device shard shape and the
``torch.distributed.tensor`` placements. Neither needs a process group.
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
    (NamedTuples keep their type; a PartitionSpec is a leaf)."""
    if isinstance(tree, PartitionSpec):
        return f(tree)
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
    if isinstance(tree, PartitionSpec) or not isinstance(tree, (dict, list, tuple)):
        return {prefix.rstrip("."): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    else:
        items = enumerate(tree)
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


def abstract(specs, dtype=None):
    """Stand-ins on the meta device: each spec's shape and dtype (``dtype``
    overrides it), no storage and no generator."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"), specs)


def n_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rules.
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (the dim
    split over all of them, the first outermost), or None (not split). A
    tuple of one name is that name, and an empty one None, as in JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, ((e[0] if len(e) == 1 else e or None)
                                     if isinstance(e, tuple) else e for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_size(mesh, ax) -> int:
    """Devices along mesh axis ``ax`` (a name or a tuple of names)."""
    return math.prod(mesh.shape[a] for a in ax) if isinstance(ax, tuple) else mesh.shape[ax]


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh`` (anything with ``shape``, an ordered name ->
    size mapping, and ``axis_names``)."""
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The per-device shape of a tensor of global ``shape``: each dim over
        the product of its mesh axes (which the rules only pick where it
        divides)."""
        out = list(shape)
        for i, ax in enumerate(self.spec):
            if ax is not None:
                n = axis_size(self.mesh, ax)
                if out[i] % n:
                    raise ValueError(f"dim {i} of {tuple(shape)} does not split over {ax} ({n})")
                out[i] //= n
        return tuple(out)

    @property
    def placements(self) -> tuple:
        """``torch.distributed.tensor`` placements, one per mesh axis in
        ``mesh.axis_names`` order: ``Shard(d)`` where tensor dim d is split
        over that axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for d, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in self.mesh.axis_names)


# Default TP/EP mapping: tensor dims that scale with the model shard over
# "model"; everything else is replicated (data/pod axes shard activations;
# ZeRO moment sharding is layered on separately).
DEFAULT_RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
    "conv": None,
    "state": None,
    None: None,
}


def spec_partition(spec: ParamSpec, rules: dict, mesh) -> PartitionSpec:
    """PartitionSpec for one parameter, each dim replicated where its rule's
    mesh axis does not divide it, and a mesh axis used by its first dim only
    (GSPMD's rule: an axis may appear once in a spec)."""
    out, seen = [], set()
    for dim, ax in zip(spec.shape, spec.axes):
        mesh_ax = rules.get(ax, None)
        if mesh_ax is None or dim % axis_size(mesh, mesh_ax) or mesh_ax in seen:
            out.append(None)
        else:
            out.append(mesh_ax)
            seen.add(mesh_ax)
    return PartitionSpec(*out)


def param_pspecs(specs, mesh, rules: dict | None = None):
    rules = {**DEFAULT_RULES, **(rules or {})}
    return tree_map(lambda s: spec_partition(s, rules, mesh), specs)


def param_shardings(specs, mesh, rules: dict | None = None):
    rules = {**DEFAULT_RULES, **(rules or {})}
    return tree_map(lambda s: NamedSharding(mesh, spec_partition(s, rules, mesh)), specs)
