#!/usr/bin/env python3
"""Device times of the flash kernel's bf16 route at the main path's shapes,
for one or more builds of ``csrc/flash_attention.cu``, beside PyTorch's
``scaled_dot_product_attention``, for pairing two trees in one call.

Run from the root of this tree, naming the sources to build (default: this
tree's; another commit's with ``git archive`` unpacked into a git-ignored
directory such as ``build/cmp/parent``):

  python3 time_flash.py [SRC ...] [--reps 3]

Each source is built with the kernels' own nvcc flags into
``build/time_flash/`` and loaded in place of this tree's library; its C
interface must be this tree's (``flash_attention_fwd_launch`` with a scratch
buffer, ``flash_attention_scratch_bytes``). The inputs are drawn once per
shape (numpy, seed 3) and shared by every build. Per shape, each build is
timed in the order given and then in reverse (A, B, B, A), ``reps`` times
each, by ``chip_smoke.time_launches`` (CUDA events, L2 flushed, 20
launches); SDPA once. Prints one JSON line per shape. Outputs are not
checked here: ``chip_smoke.py``'s ``kernels`` phase holds the kernel
against its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path``, its two entry points typed as the wrapper's."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 6
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="*", help="flash_attention.cu sources (default: this tree's)")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    smi = c.phase_device()
    srcs = a.srcs or [str(build.CSRC / "flash_attention.cu")]
    out = Path(build.BUILD_DIR).parent / "time_flash"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([build._nvcc(), *build.FLAGS, "-o", str(out / f"{i}.so"), src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, src in enumerate(srcs)]
    for src, p in zip(srcs, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
    libs = [load(out / f"{i}.so") for i in range(len(srcs))]
    order = list(range(len(srcs))) + list(range(len(srcs)))[::-1]

    rng = np.random.default_rng(3)
    shapes = {"train": c.FLASH_FULL, "granite": c.FLASH_GRANITE, "mla": c.FLASH_MLA,
              **c.WHISPER_FLASH, **c.FLASH_TP_FAMILIES}
    for label, (b, sq, sk, h, hk, d, causal) in shapes.items():
        q, k, v = c.flash_inputs(rng, b, sq, sk, h, hk, d, torch.bfloat16, "cuda")
        ms = {src: [] for src in srcs}
        for i in order:
            fa._lib_handle = libs[i]
            ms[srcs[i]] += [c.time_launches(lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
                                            n_iter=20)[0] for _ in range(a.reps)]
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa, _ = c.time_launches(lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal, enable_gqa=True), n_iter=20)
        bytes_, flops = c.flash_cost(q, k, v, causal)
        bound, by = c.bound_ms(bytes_, flops, c.BF16_FLOP_PER_S)
        print(json.dumps({"shape": label, "b_sq_sk_h_hk_d_causal": [b, sq, sk, h, hk, d, causal],
                          "ms": ms, "sdpa_ms": sdpa, "bound_ms": bound, "bound_by": by,
                          "nvidia_smi": smi}), flush=True)
    fa._lib_handle = None


if __name__ == "__main__":
    main()
