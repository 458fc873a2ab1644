#!/usr/bin/env python3
"""Host-clock times of the serving path of whisper-medium, xlstm-125m and
zamba2-2.7b on one card, for pairing two trees in one run.

Run from the root of the tree to time (this one, or another commit unpacked
with ``git archive``); it imports that tree's ``chip_smoke.py`` for the
families' configs and helpers, which builds that tree's kernels:

  python3 /path/to/time_families.py [--reps 3]

At ``chip_smoke.py``'s ``families`` (b) sizes (published widths and depth,
bf16, batch 4, whisper's 416-token prompt and 1500 frames, the recurrent
families' 2048-token prompts), per arch: ``reps`` prefills and ``reps`` x 32
decode steps from the padded cache, each synchronized and timed alone. Prints
one JSON line per arch with every time and the medians. Pair trees in one
call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c  # the tree's own

    smi = c.phase_device()
    c.phase_build()
    dev = torch.device("cuda")
    batch, steps = c.FAM_BATCH, c.FAM_STEPS
    for arch, (cfg, _, _, prompt) in c.FAMILIES.items():
        params = c.base.materialize(c.registry.get_api(cfg).specs(),
                                    torch.Generator(device=dev).manual_seed(0), device=dev)
        data = {n: v.to(dev) for n, v in
                c.family_batch(cfg, np.random.default_rng(0), batch, prompt).items()}
        prefill, step = c.serve_step.make_prefill(cfg), c.serve_step.make_serve_step(cfg)
        prefill(params, {**data, "tokens": data["tokens"][:, :16]})  # warm-up
        prefill_ms, decode_ms = [], []
        for _ in range(a.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = prefill(params, data)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            cache = c.pad_cache(cache, cfg, batch, prompt + steps)
            for t in range(steps):
                pos = torch.full((batch,), prompt + t, dtype=torch.int32, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok, cache = step(params, cache, tok[:, None], pos)
                torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(dict(phase="time_families", nvidia_smi=smi, tree=os.getcwd(), arch=arch,
                              batch=batch, prompt=prompt, reps=a.reps,
                              prefill_ms_median=statistics.median(prefill_ms),
                              decode_ms_median=statistics.median(decode_ms),
                              prefill_ms=prefill_ms, decode_ms=decode_ms)), flush=True)
        del params, cache, tok
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
