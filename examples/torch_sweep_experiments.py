"""Experiments-subsystem tour on the PyTorch port: sweeps + tail latency.

Runs a policy x wear x seed grid through the port's sweep runner
(repro_torch.experiments) on any registered scenario (synthetic generators
or the bundled MSR-style trace replay) and prints a tail-latency table —
the metric read retries actually damage. Per-run BENCH_*.json artifacts
land in --out. --devices N splits each policy group's runs across N
devices (identical results). Runs on CUDA unless --device names another
device (--device cpu runs it on the CPU).

  PYTHONPATH=src python examples/torch_sweep_experiments.py \\
      [--scenario read_disturb_hammer] [--requests 24000] [--seeds 2] [--out bench_out] \\
      [--devices N|all] [--device cpu]
  PYTHONPATH=src python examples/torch_sweep_experiments.py --list
"""

import argparse

from repro_torch import resolve_device
from repro_torch.experiments import registry, sweep
from repro_torch.ssdsim import geometry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="read_disturb_hammer")
    ap.add_argument("--requests", type=int, default=24_000)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--devices", default=None,
                    help="split each policy group's runs across N devices ('all' = every "
                         "visible device; default: one)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--list", action="store_true", help="list scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        print("registered scenarios:", ", ".join(registry.names()))
        return None
    if args.scenario not in registry.names():
        ap.error(f"unknown scenario {args.scenario!r}; have {registry.names()}")
    device = resolve_device(args.device)

    spec = sweep.SweepSpec(
        scenario=args.scenario,
        n_requests=args.requests,
        policies=(geometry.BASELINE, geometry.HOTNESS, geometry.RARO),
        initial_pe=(166, 833),
        seeds=tuple(range(args.seeds)),
        base=geometry.SimConfig(device_age_h=24.0),
    )
    print(f"== sweep: {args.scenario}, {spec.n_runs()} runs "
          f"({len(spec.policies)} policies x {len(spec.initial_pe)} wear "
          f"stages x {args.seeds} seeds) on {device} ==")
    results = sweep.run_sweep(spec, verbose=True, devices=args.devices, device=device)

    hdr = f"{'run':<44} {'mean us':>9} {'p50 us':>9} {'p95 us':>9} {'p99 us':>9} {'p999 us':>9}"
    print(hdr)
    print("-" * len(hdr))
    for r in results:
        print(f"{r['run']['tag']:<44} {r['mean_read_latency_us']:>9.1f} "
              f"{r['read_lat_p50_us']:>9.1f} {r['read_lat_p95_us']:>9.1f} "
              f"{r['read_lat_p99_us']:>9.1f} {r['read_lat_p999_us']:>9.1f}")

    if args.out:
        paths = sweep.write_artifacts(results, args.out)
        print(f"\nwrote {len(paths)} artifacts to {args.out}/")
    return results


if __name__ == "__main__":
    main()
