"""End-to-end training driver (counterpart of ``repro.launch.train``).

Runs a real training loop on synthetic-but-learnable data with checkpoint
rotation, async saves and crash-resume, on one card (or on the CPU when the
caller asks for it), or over a mesh of processes: data-parallel over its
data axes, and tensor-parallel over its "model" axis. On the card the
attention of every layer is the hand-written flash kernel, its gradient the
plain attention's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 300 --batch 16 --seq 128 [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...

The command line trains on the (world, 1) mesh, as the reference's does; a
model axis is the caller's ``run(mesh=make_mesh((d, m), ("data", "model")))``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import init_distributed, make_mesh, set_mesh
from repro_torch.models import base, registry
from repro_torch.parallel import sharding
from repro_torch.training import optim
from repro_torch.training import train_step as ts


def _data_shard(mesh) -> tuple[int, int]:
    """(this rank's index, their count) along the mesh's data axes, the
    outermost first, as the ``batch`` rule splits a batch over them."""
    index, count = 0, 1
    for ax in sharding.data_axes(mesh):
        index = index * mesh.shape[ax] + mesh.axis_index(ax)
        count *= mesh.shape[ax]
    return index, count


def data_rows(batch: int, shard: int, n_shards: int, microbatches: int = 1) -> np.ndarray:
    """Data rank ``shard``'s rows (of ``n_shards``) of a global batch of
    ``batch`` rows: its contiguous share of each of the ``microbatches``
    blocks the reference's step splits the global batch into along axis 0,
    so that microbatch j of every rank's step is its part of the
    reference's microbatch j (one block: the rank's contiguous rows)."""
    if batch % (microbatches * n_shards):
        raise ValueError(f"batch {batch} does not split into {microbatches} microbatches "
                         f"over {n_shards} data ranks")
    per, block = batch // (microbatches * n_shards), batch // microbatches
    return np.concatenate([np.arange(j * block + shard * per, j * block + (shard + 1) * per)
                           for j in range(microbatches)])


def run(arch: str, *, smoke: bool = True, steps: int = 300, batch: int = 16,
        seq: int = 128, microbatches: int = 1, ckpt_dir: str | None = None,
        ckpt_interval: int = 100, lr: float = 1e-3, log_every: int = 20,
        mesh=None, device=None, cfg: ModelConfig | None = None):
    """Train ``arch`` (its smoke variant unless ``smoke`` is False; ``cfg``,
    where given, in place of both) for ``steps`` steps. Returns (params,
    hist), hist the (step, loss) pairs logged. Parameters are drawn from a
    generator seeded 0 on ``device`` (CUDA unless the caller names one) in
    the specs' own dtypes, bf16 for tinyllama, as the reference materializes
    them. With ``ckpt_dir`` it resumes from the newest checkpoint there,
    saves every ``ckpt_interval`` steps and at the end.

    ``mesh`` (a ``launch.mesh.ProcessMesh``; its device is the run's) trains
    over its axes; without one inside a started process group, the
    reference's (world, 1) ("data", "model") mesh. Every rank draws the same
    parameters, takes its rows of each global batch (``data_rows``: its
    contiguous share of each microbatch's block; ``batch`` must divide by
    the microbatches times the data ranks), and each step averages the gradients and
    the loss over them in one all-reduce (``train_step.make_train_step``);
    ``hist`` holds the global mean loss.

    A model axis above 1 places the parameters of every family by the
    sharding rules, as the reference's ``jax.device_put`` of
    ``param_shardings`` does (``sharding.shard_params``): each rank keeps its
    block of every leaf the rules split (attention heads, MLA's heads, MLP
    width, vocabulary, experts or their width, a recurrent block's
    features), with its gradients and AdamW moments, and the steps, under
    ``set_mesh``, are tensor-parallel (``parallel/tensor.py``; the
    recurrent blocks gather the leaves whose blocks are no unit of work at
    their use, ``models/ssm.py``); the MoE layers take ``moe.moe_apply_ep``
    where ``moe._moe_ffn`` picks it. The returned
    ``params`` are this rank's (``sharding.gather_params`` makes them
    whole). Checkpoints hold whole arrays, which rank 0 writes: every rank
    restores the same step, on any mesh."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
    if mesh is None:
        dev, shard, n_shards = resolve_device(device), 0, 1
    else:
        dev = mesh.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device {device} is not the mesh's ({dev})")
        shard, n_shards = _data_shard(mesh)
    writer = mesh is None or dist.get_rank() == 0
    if cfg is None:
        cfg = smoke_variant(ARCHS[arch]) if smoke else ARCHS[arch]

    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    params = sharding.shard_params(params, cfg, mesh)
    ocfg = optim.AdamWConfig(lr=lr, warmup=20, total_steps=steps)
    opt_state = optim.init(params)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    rows = data_rows(batch, shard, n_shards, microbatches)
    step_fn = ts.make_train_step(cfg, ocfg, microbatches=microbatches, mesh=mesh)

    mgr = (CheckpointManager(ckpt_dir, interval=ckpt_interval, cfg=cfg, mesh=mesh)
           if ckpt_dir else None)
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest((params, opt_state), device=dev)
        if restored is not None:
            start, (params, opt_state), _ = restored
            if writer:
                print(f"resumed from step {start}")

    hist = []
    t0 = time.time()
    with set_mesh(mesh):
        for step in range(start, steps):
            b = {k: torch.from_numpy(v[rows]).to(dev) for k, v in data.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, b)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])
                hist.append((step, loss))
                if writer:
                    print(f"step {step:5d} loss {loss:.4f} gnorm "
                          f"{float(metrics['grad_norm']):.3f} "
                          f"({(time.time()-t0)/max(step-start+1,1)*1000:.0f} ms/step)",
                          flush=True)
            if mgr is not None and mgr.should_save(step):
                mgr.save(step, (params, opt_state))
    if mgr is not None:
        mgr.save(steps, (params, opt_state))
        mgr.wait()
        if mesh is not None:  # every rank returns once the final save is whole
            dist.barrier()
    return params, hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = ap.parse_args()
    device = a.device
    if "WORLD_SIZE" in os.environ:  # started by torchrun: one process per device
        device = init_distributed(a.device)
    try:
        _, hist = run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
                      microbatches=a.microbatches, ckpt_dir=a.ckpt_dir, lr=a.lr, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    first, last = hist[0][1], hist[-1][1]
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"loss {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
