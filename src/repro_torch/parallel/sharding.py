"""Sharding rules: logical axes -> mesh axes, per architecture (counterpart
of ``repro.parallel.sharding``).

2D layout: ("data", "model") within a pod, plus an optional leading "pod"
axis that composes with "data" for batch and gradient parallelism. Every
rule is checked for divisibility against the mesh (``base.spec_partition``
and ``_spec_for`` fall back to replication per dim), so one rule set serves
every (arch x shape x mesh) cell, on the abstract production meshes and on
the 1x1 host mesh alike (``launch/mesh.py``); per-arch overrides pick
another axis where the default cannot shard (granite's 40 experts on a
16-way model axis shard the expert FFN width instead).

The results are :class:`~repro_torch.models.base.NamedSharding` trees:
specs over a mesh, with shard shapes and ``torch.distributed.tensor``
placements. Nothing there needs a process group.

At runtime (``launch.train.run`` on a ``launch.mesh.ProcessMesh``) the
same rules place the parameters, as the reference's ``jax.device_put`` of
``param_shardings`` does: ``shard_params`` keeps each rank's block of every
leaf whose spec splits it over "model", and ``gather_params`` all-gathers
the blocks into whole leaves again (checkpoints, ``convert``). Every
family is placed, its stacked layer groups
(``layers``, ``enc_layers``/``dec_layers``, ``mamba_layers``,
``moe_layers``/``dense_layers``) and its ``mtp`` and ``shared`` subtrees
leaf by leaf, as the dry run's per-device bytes count them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base, registry
from repro_torch.models.base import NamedSharding, PartitionSpec
from repro_torch.parallel import collectives as C
from repro_torch.training.optim import OptState


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def tp_size(mesh) -> int:
    return mesh.shape["model"]


def make_rules(cfg: ModelConfig, mesh) -> dict:
    tp = tp_size(mesh)
    rules = dict(base.DEFAULT_RULES)
    # GQA: shard the KV projections over heads only where the heads divide;
    # otherwise replicate KV (queries stay head-sharded)
    if cfg.n_kv_heads % tp != 0:
        rules["kv_heads"] = None
    if cfg.n_heads % tp != 0:
        rules["heads"] = None
    # MoE: expert-parallel where E % tp == 0, else tensor-parallel experts
    rules["moe_ff"] = None
    if cfg.n_experts:
        if cfg.n_experts % tp == 0:
            rules["experts"] = "model"
        else:
            rules["experts"] = None
            rules["moe_ff"] = "model"
    # batch-like axes (inputs, caches)
    rules["batch"] = data_axes(mesh)
    rules["seq"] = None
    return rules


def param_shardings(cfg: ModelConfig, specs, mesh):
    return base.param_shardings(specs, mesh, make_rules(cfg, mesh))


def split_dims(cfg: ModelConfig, mesh) -> list:
    """For each leaf of ``cfg``'s parameter tree (``tree_leaves`` order), the
    dim that the runtime splits over "model" on ``mesh``, or None: the rules'
    ``param_pspecs``, None everywhere on a model axis of 1. The params are
    never split over a data axis."""
    specs = registry.get_api(cfg).specs()
    if tp_size(mesh) == 1:
        return [None] * len(base.tree_leaves(specs))
    pspecs = base.param_pspecs(specs, mesh, make_rules(cfg, mesh))
    return [next((d for d, ax in enumerate(ps) if ax == "model"), None)
            for ps in base.tree_leaves(pspecs)]


def _map_placed(fn, tree, cfg, mesh):
    """``fn(leaf, dim)`` on each leaf of a parameter tree, or of each
    parameter-shaped tree in ``tree``: an ``OptState``'s moments (its count
    kept), or a tuple of such trees."""
    if isinstance(tree, OptState):
        return OptState(_map_placed(fn, tree.m, cfg, mesh), _map_placed(fn, tree.v, cfg, mesh),
                        tree.count)
    if isinstance(tree, tuple):
        return tuple(_map_placed(fn, t, cfg, mesh) for t in tree)
    dims = split_dims(cfg, mesh)
    return base.tree_unflatten(tree, [fn(t, d) for t, d in zip(base.tree_leaves(tree), dims)])


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's block of each leaf that the rules split over ``mesh``'s
    "model" axis (the blocks in rank order, as GSPMD tiles a dim), a copy of
    its own; whole leaves are kept as they are. Takes a parameter tree, an
    ``OptState`` or a tuple of them."""
    if mesh is None or tp_size(mesh) == 1:
        return params
    tp, r = tp_size(mesh), mesh.axis_index("model")
    return _map_placed(lambda t, d: t if d is None else t.chunk(tp, d)[r].clone(),
                       params, cfg, mesh)


def whole_like(params, cfg: ModelConfig, mesh):
    """Meta-device stand-ins of ``params``' whole leaves (their shapes before
    ``shard_params``, their dtypes): what a checkpoint of them holds."""
    tp = tp_size(mesh)

    def whole(t, d):
        shape = list(t.shape)
        if d is not None:
            shape[d] *= tp
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return _map_placed(whole, params, cfg, mesh)


@torch.no_grad()
def gather_params(params, cfg: ModelConfig, mesh):
    """The inverse of ``shard_params``: every split leaf all-gathered whole
    over "model" (a collective: every rank of the mesh calls it, and every
    rank gets the whole tree)."""
    if mesh is None or tp_size(mesh) == 1:
        return params
    gm = mesh.group("model")
    return _map_placed(lambda t, d: t if d is None else C.unshard(t, gm, d), params, cfg, mesh)


def _spec_for(shape, axes, rules, mesh) -> PartitionSpec:
    """Each dim over its rule's mesh axis (or axes) where they divide it and
    their first axis is not taken by an earlier dim, else replicated."""
    out, used = [], set()
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax)
        if mesh_ax is None:
            out.append(None)
            continue
        key = mesh_ax if isinstance(mesh_ax, str) else mesh_ax[0]
        if dim % base.axis_size(mesh, mesh_ax) == 0 and key not in used:
            out.append(mesh_ax)
            used.add(key)
        else:
            out.append(None)
    return PartitionSpec(*out)


# logical axes of the standard batch inputs
_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "img_embeds": ("batch", "seq", None),
    "pos": ("batch",),
}


def batch_shardings(cfg: ModelConfig, batch_abstract, mesh):
    """NamedShardings for a train/prefill batch dict or the decode inputs
    (tokens, pos, cache)."""
    rules = make_rules(cfg, mesh)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if k == "cache":
                out[k] = cache_shardings(cfg, v, mesh)
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                axes = _BATCH_AXES.get(k, (None,) * v.dim())
                out[k] = NamedSharding(mesh, _spec_for(v.shape, axes[: v.dim()], rules, mesh))
        return out

    return walk(batch_abstract)


def cache_shardings(cfg: ModelConfig, cache_abstract, mesh, *, seq_shard: bool = False):
    """KV and recurrent-state cache shardings: batch over the data axes, KV
    heads over "model" where divisible (replicated per dim otherwise).

    seq_shard=True: where no dim of a 4D+ cache uses the model axis (GQA
    kv_heads < tp, or MLA's un-headed latent), shard its SEQUENCE dim (2)
    over "model" instead, flash-decoding style. (The reference tests "model"
    against ``jax.tree_util.tree_leaves`` of its spec, which under the JAX
    it pins is the spec itself, so it also adds "model" at dim 2 of a cache
    whose heads already use it; the port applies the rule as stated.)
    """
    rules = make_rules(cfg, mesh)
    tp = tp_size(mesh)

    # axes from shapes: dim 0 = layers / applications, dim 1 = batch, the
    # dim matching n_kv_heads = kv_heads; for 4D (L, B, S, R) latent caches
    # dim 2 is the sequence
    def one(x):
        axes = []
        for i, dim in enumerate(x.shape):
            if i == 0 and x.dim() >= 3:
                axes.append(None)
            elif (i == 1 and x.dim() >= 3) or (i == 0 and x.dim() < 3):
                axes.append("batch")
            elif dim == cfg.n_kv_heads and i >= 2:
                axes.append("kv_heads")
            elif cfg.family in ("ssm", "hybrid") and dim == cfg.n_heads and i >= 2:
                axes.append("heads")
            else:
                axes.append(None)
        spec = _spec_for(x.shape, tuple(axes), rules, mesh)
        if seq_shard and "model" not in spec and x.dim() >= 4 and x.shape[2] % tp == 0:
            spec = PartitionSpec(*spec[:2], "model", *spec[3:])
        return NamedSharding(mesh, spec)

    return base.tree_map(one, cache_abstract)
