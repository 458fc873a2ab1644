"""Training cells: ``training/train_step.py::make_train_step`` of the
program, over batches of packed documents (``traffic.packed_batches``).

Set-up builds the one step object with its parameters and AdamW state and
drives it through the mix's ``check.steps`` first steps on batches 0, 1, 2,
..., reading what the reference later follows: each step's loss, the first
clipped gradient per leaf (AdamW's first moment after one step over
1 - b1) and the change of each leaf over those steps. The window then runs
the same object on the next batches until ``--seconds`` have passed and ends
in a synchronize; the losses stay on the device until it has ended.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from cardbench import harness, traffic, weights
from cardbench.reference import transformer as ref


@dataclass
class State:
    leaves: list
    params: object
    opt: object
    step: object
    tokens: torch.Tensor
    labels: torch.Tensor
    b1: float
    losses: list = field(default_factory=list)
    grad1: dict = field(default_factory=dict)
    change: dict = field(default_factory=dict)
    window_losses: list = field(default_factory=list)
    next_batch: int = 0


def _batch(st: State, ctx):
    i = st.next_batch % st.tokens.shape[0]
    st.next_batch += 1
    b = {"tokens": st.tokens[i], "labels": st.labels[i]}
    if ctx.fault == "half_batch":  # the planted fault: half the rows left out
        b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
    return b


def _run_step(st: State, ctx):
    if ctx.fault == "state_unchanged":  # the planted fault: the update returns its inputs
        from repro_torch.training import optim

        update = optim.update
        optim.update = lambda ocfg, params, grads, state, *a: (params, state, {})
        try:
            st.params, st.opt, m = st.step(st.params, st.opt, _batch(st, ctx))
        finally:
            optim.update = update
        return m
    st.params, st.opt, m = st.step(st.params, st.opt, _batch(st, ctx))
    return m


def setup(ctx, mark=lambda name: None) -> State:
    from repro_torch.models import base
    from repro_torch.training import optim, train_step

    c, t = ctx.cell.config, ctx.cell.traffic
    cfg = harness.port_config(c)
    leaves = ref.param_leaves(c, harness.table_rows(cfg))
    tensors = weights.make(leaves, ctx.seed, ctx.device)
    params = harness.program_params(cfg, tensors, c["port"]["param_dtype"])
    ocfg = optim.AdamWConfig(**t["optimizer"])
    tokens, labels = traffic.packed_batches(t, c["vocab_size"], ctx.seed, ctx.device)
    st = State(leaves, params, optim.init(params), train_step.make_train_step(cfg, ocfg),
               tokens, labels, ocfg.b1)
    mark("weights_state_batches")
    for i in range(t["check"]["steps"]):
        m = _run_step(st, ctx)
        st.losses.append(m["loss"])
        if i == 0:
            st.grad1 = {p: torch.linalg.vector_norm(x.float()) / (1 - st.b1)
                        for p, x in base.tree_paths(st.opt.m).items()}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    mark("checked_steps")
    st.change = weights.change_norms(leaves, ctx.seed, ctx.device, tensors)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return st


def window(ctx, st: State, seconds: float, traced: bool) -> harness.Window:
    t = ctx.cell.traffic
    cap = t["trace"]["steps"] if traced else None
    n = 0
    t0 = time.perf_counter()
    while True:
        st.window_losses.append(_run_step(st, ctx)["loss"])
        n += 1
        if (cap is not None and n >= cap) or (cap is None and time.perf_counter() - t0 >= seconds):
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    s = time.perf_counter() - t0
    tokens = n * t["batch"] * t["seq"]
    return harness.Window(units=n, seconds=s, end_to_end={"train_tokens_per_s": tokens / s})


def keep(ctx, st: State, win) -> dict:
    names = [leaf[0] for leaf in st.leaves]
    if st.window_losses:
        win.failed = int((~torch.isfinite(torch.stack(st.window_losses).float())).sum())
    return {"losses": [float(x) for x in st.losses],
            "grad1": torch.stack([st.grad1[n] for n in names]).cpu(),
            "change": st.change.cpu(), "nonfinite": win.failed}


def reference(ctx, prec=ref.F32) -> dict:
    """The reference's readings of the same first steps: losses, the first
    clipped gradient's norm per leaf, each leaf's change."""
    c, t = ctx.cell.config, ctx.cell.traffic
    cfg = harness.port_config(c)
    leaves = ref.param_leaves(c, harness.table_rows(cfg))
    tensors = weights.make(leaves, ctx.seed, ctx.device)
    params = {n: tensors[n].float().clone() for n, *_ in leaves}
    dtypes = {n: weights.dtype_of(dt) for n, _, _, dt in leaves}
    del tensors
    harness.free(ctx.device)
    tokens, labels = traffic.packed_batches(t, c["vocab_size"], ctx.seed, ctx.device)
    steps = t["check"]["steps"]
    batches = [(tokens[i], labels[i]) for i in range(steps)]
    del tokens, labels
    losses, grad1 = ref.train(params, dtypes, batches, c, t["optimizer"], prec)
    change = weights.change_norms(leaves, ctx.seed, ctx.device, params)
    del params
    harness.free(ctx.device)
    return {"losses": losses, "grad1": grad1.cpu(), "change": change.cpu(), "nonfinite": 0}


def numbers(prog: dict, refr: dict) -> dict:
    """The compared numbers: each step's loss gap (relative), and by the
    worst leaf the gap between the program's norm and the reference's, of
    the first clipped gradient and of the change over the steps, against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))
    g_ref = refr["grad1"].double()
    g_med = statistics.median(g_ref.tolist())
    grad = float(((prog["grad1"].double() - g_ref).abs() / torch.clamp(g_ref, min=g_med)).max())
    moved = g_ref >= 1e-3 * g_med
    c_ref = refr["change"].double()[moved]
    c_med = statistics.median(c_ref.tolist())
    change = float(((prog["change"].double()[moved] - c_ref).abs()
                    / torch.clamp(c_ref, min=c_med)).max())
    return {"loss_gap": loss, "grad_leaf_gap": grad, "change_leaf_gap": change,
            "nonfinite_losses": float(prog["nonfinite"])}


def check(ctx, kept: dict) -> dict:
    return numbers(kept, reference(ctx))
