"""End-to-end training driver (counterpart of ``repro.launch.train``).

Runs a real training loop on synthetic-but-learnable data with checkpoint
rotation, async saves and crash-resume, on one card (or on the CPU when the
caller asks for it). On the card the attention of every layer is the
hand-written flash kernel, its gradient the plain attention's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 300 --batch 16 --seq 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import base, registry
from repro_torch.training import optim
from repro_torch.training import train_step as ts


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
    saves every ``ckpt_interval`` steps and at the end. ``mesh`` is the
    reference's device mesh; the port runs on one card and takes none."""
    if mesh is not None:
        raise NotImplementedError("the port trains on one card; meshes wait for the multi-card "
                                  "slice (ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    if cfg is None:
        cfg = smoke_variant(ARCHS[arch]) if smoke else ARCHS[arch]

    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    ocfg = optim.AdamWConfig(lr=lr, warmup=20, total_steps=steps)
    opt_state = optim.init(params)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    step_fn = ts.make_train_step(cfg, ocfg, microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval) if ckpt_dir else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest((params, opt_state), device=dev)
        if restored is not None:
            start, (params, opt_state), _ = restored
            print(f"resumed from step {start}")

    hist = []
    t0 = time.time()
    for step in range(start, steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            hist.append((step, loss))
            print(f"step {step:5d} loss {loss:.4f} gnorm "
                  f"{float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(step-start+1,1)*1000:.0f} ms/step)",
                  flush=True)
        if mgr is not None and mgr.should_save(step):
            mgr.save(step, (params, opt_state))
    if mgr is not None:
        mgr.save(steps, (params, opt_state))
        mgr.wait()
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
    _, hist = run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
                  microbatches=a.microbatches, ckpt_dir=a.ckpt_dir, lr=a.lr, device=a.device)
    first, last = hist[0][1], hist[-1][1]
    print(f"loss {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
