"""Training step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation (counterpart of ``repro.training.train_step``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base, registry
from repro_torch.training import optim


def make_loss_fn(cfg: ModelConfig):
    return registry.get_api(cfg).loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, gradients in the parameters' tree and dtypes) of one batch."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in base.tree_leaves(params)]
        loss = loss_fn(base.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), base.tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    which updates ``params`` and ``opt_state`` in place (``optim.update``).

    With microbatches > 1, the batch is split along axis 0 and the splits'
    gradients are summed in float32 and divided by their count (the
    reference's ``lax.scan``).
    """
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
            grads = base.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mbatch in zip(*(torch.chunk(x, microbatches) for x in batch.values())):
                l, g = value_and_grad(loss_fn, params, dict(zip(batch, mbatch)))
                for acc, gi in zip(base.tree_leaves(grads), base.tree_leaves(g)):
                    acc.add_(gi.float())
                loss = loss + l
            grads = base.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches

        params, opt_state, metrics = optim.update(ocfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
