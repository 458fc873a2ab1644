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
placements. Nothing here needs a process group.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base
from repro_torch.models.base import NamedSharding, PartitionSpec


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
