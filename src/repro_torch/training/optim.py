"""AdamW with a warmup-cosine learning rate and global-norm clipping
(counterpart of ``repro.training.optim``).

Moments are float32 whatever the parameters' dtype; each parameter is
updated in float32 and rounded back to its own dtype. ``update`` works in
place: it overwrites the parameters and moments it is given (as the
reference's jitted step overwrites its donated buffers), so a step needs no
second copy of the moments, 8.8 GB at tinyllama-1.1b's size. The
reference's docstring names ZeRO-style moment sharding, but its code has
none (``opt_state_specs`` mirrors the parameters' specs, and its launcher
never places the moments): here, as there, every data rank holds the
moments of the parameters it holds, which on a model axis above 1 are this
rank's blocks of the split parameters (``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.models import base
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import collectives as C


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor  # int32, 0-dim: steps taken


def opt_state_specs(param_specs) -> OptState:
    """Moment specs: the parameters' shapes and axes, f32 zeros."""
    f32 = base.tree_map(lambda s: ParamSpec(s.shape, s.axes, "zeros", torch.float32),
                        param_specs)
    return OptState(m=f32, v=f32, count=ParamSpec((), (), "zeros", torch.int32))


def init(params) -> OptState:
    def zeros():
        return base.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)

    device = base.tree_leaves(params)[0].device
    return OptState(m=zeros(), v=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (an int tensor): linear warmup, then cosine to 0."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree, split=None, group=None):
    """The L2 norm of every leaf of ``tree`` together. With ``group`` (the
    mesh's "model" group) the leaves that ``split`` marks (one flag a leaf)
    are this rank's blocks: their squares are summed over the group, and the
    whole leaves, alike on every rank, are counted once."""
    squares = [torch.sum(torch.square(g.float())) for g in base.tree_leaves(tree)]
    if group is None:
        return torch.sqrt(sum(squares))
    zero = torch.zeros_like(squares[0])
    parts = sum((sq for sq, s in zip(squares, split) if s), zero)
    whole = sum((sq for sq, s in zip(squares, split) if not s), zero)
    return torch.sqrt(C.psum(parts, group) + whole)


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState, split=None, group=None):
    """One AdamW step, in place. Returns (params, state, metrics): the same
    parameter and moment tensors, overwritten, and a new step count.
    ``split`` and ``group``, for parameters split over a model axis, as
    ``global_norm`` takes them: the clipping reads the whole model's norm."""
    gnorm = global_norm(grads, split, group)
    # a tensor numerator: torch computes `scalar / tensor` as a reciprocal times the scalar
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    for p, g, m, v in zip(*(base.tree_leaves(t) for t in (params, grads, state.m, state.v))):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, OptState(state.m, state.v, count), {"grad_norm": gnorm, "lr": lr}
