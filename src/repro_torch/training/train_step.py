"""Training step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation (counterpart of ``repro.training.train_step``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models import base, registry
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.training import optim


def make_loss_fn(cfg: ModelConfig):
    return registry.get_api(cfg).loss_fn


def value_and_grad(loss_fn, params, batch, idle=()):
    """(loss, gradients in the parameters' tree and dtypes) of one batch.

    ``idle`` names the subtrees (dotted paths, a family's ``idle_params``)
    that the loss may not reach, such as the block an xLSTM layer does not
    run: a leaf there gets a zero gradient, as JAX gives it. Any other leaf
    that the loss does not reach (a broken graph) raises."""
    paths = list(base.tree_paths(params))
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in base.tree_leaves(params)]
        with spans.span("train.forward"):
            loss = loss_fn(base.tree_unflatten(params, leaves), batch)
        with spans.span("train.backward"):
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    for i, (path, g) in enumerate(zip(paths, grads)):
        if g is None:
            if not any(path.startswith(f"{sub}.") for sub in idle):
                raise RuntimeError(f"the loss does not reach parameter {path}")
            grads[i] = torch.zeros_like(leaves[i])
    return loss.detach(), base.tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, microbatches: int = 1,
                    mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    which updates ``params`` and ``opt_state`` in place (``optim.update``).

    With microbatches > 1, the batch is split along axis 0 and the splits'
    gradients are summed in float32 and divided by their count (the
    reference's ``lax.scan``).

    With ``mesh`` (a ``launch.mesh.ProcessMesh``), ``batch`` is this rank's
    share along the data axes (with microbatches, its part of each of the
    reference's microbatches in turn: ``launch.train.data_rows``; an MoE
    layer's capacity and drops are then those of the reference's microbatch
    over the data ranks, ``moe.moe_apply``), and after the accumulation the step makes one
    all-reduce over them: the gradients' mean and the loss's, the
    reference's deferred psum (none where the data axes hold one rank, whose
    mean is the identity). Every rank then runs the same update. Where
    the mesh's model axis splits the parameters (``sharding.shard_params``),
    each rank's ``params`` and gradients are its blocks: the forward's
    collectives already sum every gradient over "model" that needs it (the
    whole leaves' partial cotangents through ``collectives.replicated``), so
    the step adds none, and the clipping norm sums the blocks' squares over
    "model" (``optim.global_norm``).
    """
    api = registry.get_api(cfg)
    loss_fn = api.loss_fn
    split = group = None
    data_ranks = 1 if mesh is None else dist.get_world_size(mesh.data_group)
    if mesh is not None and sharding.tp_size(mesh) > 1:
        split = [d is not None for d in sharding.split_dims(cfg, mesh)]
        group = mesh.group("model") if any(split) else None

    def train_step(params, opt_state, batch):
        with spans.span("train.step"):
            if microbatches == 1:
                loss, grads = value_and_grad(loss_fn, params, batch, api.idle_params)
            else:
                b = batch["tokens"].shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
                grads = base.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                            device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                for mbatch in zip(*(torch.chunk(x, microbatches) for x in batch.values())):
                    l, g = value_and_grad(loss_fn, params, dict(zip(batch, mbatch)),
                                          api.idle_params)
                    for acc, gi in zip(base.tree_leaves(grads), base.tree_leaves(g)):
                        acc.add_(gi.float())
                    loss = loss + l
                grads = base.tree_map(lambda g: g / microbatches, grads)
                loss = loss / microbatches

            if data_ranks > 1:
                loss, *leaves = C.mean_over([loss, *base.tree_leaves(grads)], mesh.data_group)
                grads = base.tree_unflatten(grads, leaves)
            with spans.span("train.optimizer"):
                params, opt_state, metrics = optim.update(ocfg, params, grads, opt_state, split,
                                                          group)
            metrics["loss"] = loss
            return params, opt_state, metrics

    return train_step
