"""End-to-end training example on the PyTorch port: train the tinyllama-1.1b
family at reduced width (its smoke variant) for a few hundred steps on the
synthetic-but-learnable stream through repro_torch.launch.train.run, with
checkpointing and resume. Runs on CUDA unless --device names another device
(--device cpu runs it on the CPU).

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]
"""

import argparse
import math
import tempfile

from repro_torch import resolve_device
from repro_torch.launch.train import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="raro_ckpt_")
    print(f"checkpoints -> {ckpt}")
    _, hist = run(args.arch, smoke=True, steps=args.steps, batch=args.batch,
                  seq=args.seq, ckpt_dir=ckpt, ckpt_interval=100, lr=2e-3, device=device)
    print(f"loss: {hist[0][1]:.3f} -> {hist[-1][1]:.3f} "
          f"(ln(vocab) = {math.log(512):.3f})")
    return hist


if __name__ == "__main__":
    main()
