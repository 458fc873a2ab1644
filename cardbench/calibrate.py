"""The readings that a cell's limits are set from, on the card.

    python3 cardbench/calibrate.py --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...] [--fault-seeds <n> ...]

For each seed, in one process: the program's numbers (the timed entry at the
cell's sizes, driven through the same set-up, and for serving one cycle of
the window at the cell's load) against the plain reference; for each
control seed, the reference itself in the program's place at the control's
precision (float8 operands where the configuration states bf16); for each
fault seed, the program with a fault planted (training: half of each batch
left out, or the update returning its state unchanged; serving: each served
token altered where it is produced). Prints
one JSON line a reading. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # as a script: the checkout's root and src/ on the path
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "cardbench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from cardbench import harness  # noqa: E402
from cardbench.reference import transformer as ref  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def control_prefill(refr) -> dict:
    """The control's numbers: at every position of the sampled prompts, the
    gap in the reference's logits of the token the control puts first; its
    K and V against the reference's."""
    from cardbench.runners import prefill as drv

    token, kv = 0.0, 0.0
    for (lr, rk, rv), (lc, ck, cv) in zip(refr["out"][False], refr["out"][True]):
        pick = lc.argmax(-1, keepdim=True)
        token = max(token, float((lr.max(-1).values - lr.gather(-1, pick)[:, 0]).max()))
        kv = max(kv, drv.kv_gap(ck, cv, rk, rv))
    return {"token_gap": token, "kv_gap": kv}


def worst_leaves(cell, prog, refr, n=3) -> dict:
    """The leaves that read highest, for the first gradient and the change."""
    names = [leaf[0] for leaf in ref.param_leaves(cell.config)]
    out = {}
    for key in ("grad1", "change"):
        r = refr[key].double()
        gap = (prog[key].double() - r).abs() / torch.clamp(r, min=float(r.median()))
        top = torch.argsort(gap, descending=True)[:n].tolist()
        out[key] = [[names[i], float(gap[i])] for i in top]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calibrate(harness.cell(args.workload), torch.device("cuda:0"), args.seeds,
              args.control_seeds, args.fault_seeds)


def calibrate(cell, dev, seeds, control_seeds=(), fault_seeds=()):
    drv = harness.runner(cell.traffic)
    kind = cell.traffic["runner"]
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, dev, False)
        st = drv.setup(ctx)
        win = drv.window(ctx, st, 0.0, traced=True) if kind == "prefill" else \
            harness.Window(0, 0.0, {})
        kept = drv.keep(ctx, st, win)
        del st
        harness.free(dev)
        control = seed in control_seeds
        if kind == "train":
            refr = drv.reference(ctx)
            emit(seed=seed, reading="program", **drv.numbers(kept, refr),
                 losses=kept["losses"], ref_losses=refr["losses"],
                 worst=worst_leaves(cell, kept, refr))
            if control:
                ctrl = drv.reference(ctx, ref.FP8)
                emit(seed=seed, reading="control", **drv.numbers(ctrl, refr), losses=ctrl["losses"])
            for fault in ("half_batch", "state_unchanged") if seed in fault_seeds else ():
                fctx = harness.Context(cell, seed, dev, False, fault=fault)
                st = drv.setup(fctx)
                fk = drv.keep(fctx, st, harness.Window(0, 0.0, {}))
                del st
                harness.free(dev)
                emit(seed=seed, reading=fault, **drv.numbers(fk, refr), losses=fk["losses"])
        else:
            precs = (ref.F32, ref.FP8) if control else (ref.F32,)
            refr = drv.reference(ctx, all_logits=control, precs=precs)
            emit(seed=seed, reading="program", **drv.numbers(kept, refr))
            if control:
                emit(seed=seed, reading="control", **control_prefill(refr))
            if seed in fault_seeds:
                bad = {"served": {i: t + 1 for i, t in kept["served"].items()},
                       "kept": kept["kept"]}
                emit(seed=seed, reading="token_altered", **drv.numbers(bad, refr))
        del refr, kept
        harness.free(dev)
        emit(seed=seed, seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
