"""Quickstart on the PyTorch port: the paper in 60 seconds.

Runs the port's flash simulator (repro_torch.ssdsim) with the three schemes
of §V (Baseline / Hotness / RARO) on a Zipf-1.2 random-read workload at the
middle wear stage, and prints the paper's headline numbers: random-read
IOPS and usable-capacity loss. Runs on CUDA unless --device names another
device (--device cpu runs it on the CPU).

  PYTHONPATH=src python examples/torch_quickstart.py [--requests 100000] [--device cpu]
"""

import argparse

from repro_torch import resolve_device
from repro_torch.ssdsim import engine, geometry, workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=100_000)
    ap.add_argument("--zipf", type=float, default=1.2)
    ap.add_argument("--stage", default="middle", choices=["young", "middle", "old"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pe = {"young": 166, "middle": 500, "old": 833}[args.stage]
    print(f"== RARO quickstart: zipf {args.zipf}, {args.stage} stage "
          f"(P/E={pe}), {args.requests} reads ==")
    results = {}
    for pol in (geometry.BASELINE, geometry.HOTNESS, geometry.RARO):
        cfg = geometry.SimConfig(policy=pol, initial_pe=pe, device_age_h=24.0)
        tr = workload.zipf_read_trace(cfg, args.requests, args.zipf, seed=1)
        s, _ = engine.run(cfg, tr, device=device)
        m = engine.summarize(s, cfg)
        results[pol] = m
        print(f"{geometry.POLICY_NAMES[pol]:>9}: IOPS={m['iops']:>9.0f}  "
              f"retries/read={m['retries_per_read']:.2f}  "
              f"capacity loss={m['capacity_loss_gib']*1024:.0f} MiB  "
              f"migrated pages={m['migrated_pages']:.0f}")

    b, h, r = (results[p] for p in (geometry.BASELINE, geometry.HOTNESS, geometry.RARO))
    print(f"\nRARO vs Baseline IOPS: {r['iops']/b['iops']:.1f}x "
          f"(paper: 9.3–14.25x)")
    save = 1 - r["capacity_loss_gib"] / max(h["capacity_loss_gib"], 1e-9)
    print(f"RARO vs Hotness capacity-loss saving: {save*100:.0f}% "
          f"(paper: 38.6–77.6%)")
    return results


if __name__ == "__main__":
    main()
