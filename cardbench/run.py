"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up (imports, the CUDA context, the kernels from the checkout's build
directory, the weights drawn on the card from the seed, the warm-up), then
measures for ``--seconds`` and checks what the timed path produced against
the plain reference in ``cardbench/reference/``. The last line of standard
output is one JSON object; the compared numbers and their limits are the
last lines of standard error. With ``--trace 1`` the window runs under
torch.profiler and the line carries the per-layer metrics in place of the
end-to-end ones.

Exits non-zero, printing no result, without a CUDA card, or where the
process holds ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package)
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "cardbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # the checkout's root and src/, not this file's directory, on the path
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "cardbench"]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from cardbench import harness

    cell = harness.cell(args.workload)
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"cardbench: needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"cardbench: the process holds {found}, which the port may not load",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
