#!/usr/bin/env python3
"""Device times of the flash kernels at the main path's shapes, for one or
more builds of ``csrc/flash_attention.cu`` (the forward) or, with ``--bwd``,
of ``csrc/flash_attention_bwd.cu`` (the backward), beside PyTorch's
``scaled_dot_product_attention`` (its forward, or its backward), for pairing
two trees in one call.

Run from the root of this tree, naming the sources to build (default: this
tree's; another commit's with ``git archive`` unpacked into a git-ignored
directory such as ``build/cmp/parent``):

  python3 time_flash.py [SRC ...] [--reps 3] [--bwd]

Each source is built with the kernels' own nvcc flags into
``build/time_flash/`` and loaded in place of this tree's library; its C
interface must be this tree's (``flash_attention_fwd_launch`` with a scratch
buffer and ``flash_attention_scratch_bytes``; ``flash_attention_bwd_launch``
with its scratch, which this tree's wrapper sizes, at least the (B, H, Sq)
f32 Delta an older build takes). The inputs are drawn once per shape (numpy,
seed 3) and shared by every build. Per shape, each build is timed in the
order given and then in reverse (A, B, B, A), ``reps`` times each, by
``chip_smoke.time_launches`` (CUDA events, L2 flushed); SDPA once. Each
build's outputs on the shape's inputs are held against the first build's:
bit-equal or not, and the largest difference. The forward: bf16 at the
``times`` phase's shapes, timed; f32 at the training shape, outputs only.
The backward: bf16 at the same shapes, timed; then f32, timed, at every
shape of ``chip_smoke.check_flash_bwd`` and the default training entry's,
each build's gradients also held against the plain version (f64), beside
SDPA's f32 backward. Prints one JSON line per shape and type.
``chip_smoke.py``'s ``kernels`` phase holds the kernels against their plain
versions.
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


def load(path: Path, bwd: bool) -> ctypes.CDLL:
    """The library at ``path``, its entry points typed as the wrapper's."""
    lib = ctypes.CDLL(str(path))
    if bwd:
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        return lib
    lib.flash_attention_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 6
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def against_first(outs):
    """Per build after the first: whether its outputs equal the first's bit
    for bit, and the largest absolute difference."""
    first = outs[0]
    return [dict(bit_equal=all(torch.equal(a, r) for a, r in zip(o, first)),
                 max_abs_diff=max(float((a.float() - r.float()).abs().max())
                                  for a, r in zip(o, first)))
            for o in outs[1:]]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="*", help="kernel sources (default: this tree's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bwd", action="store_true", help="time the backward's builds")
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb

    smi = c.phase_device()
    name = "flash_attention_bwd" if a.bwd else "flash_attention"
    srcs = a.srcs or [str(build.CSRC / f"{name}.cu")]
    out = Path(build.BUILD_DIR).parent / "time_flash"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([build._nvcc(), *build.FLAGS, "-o", str(out / f"{name}{i}.so"), src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, src in enumerate(srcs)]
    for src, p in zip(srcs, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
    libs = [load(out / f"{name}{i}.so", a.bwd) for i in range(len(srcs))]
    mod = fb if a.bwd else fa
    order = list(range(len(srcs))) + list(range(len(srcs)))[::-1]

    rng = np.random.default_rng(3)
    if not a.bwd:  # the f32 route, outputs against the first build's
        b, sq, sk, h, hk, d, causal = c.FLASH_FULL
        q, k, v = c.flash_inputs(rng, b, sq, sk, h, hk, d, torch.float32, "cuda")
        outs = []
        for lib in libs:
            fa._lib_handle = lib
            outs.append((fa.flash_attention_fwd(q, k, v, causal=causal),))
        print(json.dumps({"f32_shape": "train", "b_sq_sk_h_hk_d_causal": list(c.FLASH_FULL),
                          "kernel": name, "against_first": against_first(outs), "srcs": srcs}),
              flush=True)
        del q, k, v, outs

    shapes = {"train": c.FLASH_FULL, "granite": c.FLASH_GRANITE, "mla": c.FLASH_MLA,
              **c.WHISPER_FLASH, **c.FLASH_TP_FAMILIES}
    for label, (b, sq, sk, h, hk, d, causal) in shapes.items():
        q, k, v = c.flash_inputs(rng, b, sq, sk, h, hk, d, torch.bfloat16, "cuda")
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if a.bwd:
            o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
            do = c.normal(rng, o.shape, o.dtype, o.device)

            def run():
                return fb.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

            # the yardstick: SDPA's backward, through autograd on (B, H, S, D) leaves
            leaves = [t.requires_grad_() for t in (ql, kl, vl)]
            ol = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                                  enable_gqa=True)
            dol = do.transpose(1, 2).contiguous()
            lib_ms, _ = c.time_launches(
                lambda: torch.autograd.grad(ol, leaves, dol, retain_graph=True), n_iter=20)
            del ol, leaves, dol
            bytes_, flops = c.flash_bwd_cost(q, k, v, causal)
        else:
            def run():
                return (fa.flash_attention_fwd(q, k, v, causal=causal),)

            lib_ms, _ = c.time_launches(lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True), n_iter=20)
            bytes_, flops = c.flash_cost(q, k, v, causal)
        ms = {src: [] for src in srcs}
        for i in order:
            mod._lib_handle = libs[i]
            ms[srcs[i]] += [c.time_launches(run, n_iter=20)[0] for _ in range(a.reps)]
        outs = []
        for lib in libs:
            mod._lib_handle = lib
            outs.append(run())
        bound, by = c.bound_ms(bytes_, flops, c.BF16_FLOP_PER_S)
        print(json.dumps({"shape": label, "b_sq_sk_h_hk_d_causal": [b, sq, sk, h, hk, d, causal],
                          "kernel": name, "ms": ms,
                          ("sdpa_backward_ms" if a.bwd else "sdpa_ms"): lib_ms,
                          "bound_ms": bound, "bound_by": by, "against_first": against_first(outs),
                          "nvidia_smi": smi}), flush=True)
        del q, k, v, ql, kl, vl, outs
        torch.cuda.empty_cache()

    if a.bwd:  # the f32 route
        for label, (b, sq, sk, h, hk, d, causal) in c.FLASH_BWD_F32_SHAPES.items():
            q, k, v = c.flash_inputs(rng, b, sq, sk, h, hk, d, torch.float32, "cuda")
            o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
            do = c.normal(rng, o.shape, o.dtype, o.device)

            def run():
                return fb.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

            ms = {src: [] for src in srcs}
            for i in order:
                fb._lib_handle = libs[i]
                ms[srcs[i]] += [c.time_launches(run, n_iter=5, warmup=2)[0]
                                for _ in range(a.reps)]
            outs = []
            for lib in libs:
                fb._lib_handle = lib
                outs.append(run())
            refs = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                block_k=fb.kernel_bwd_block(d, torch.float32))
            plain_err = {src: {n: float((g.double() - r.double()).abs().max())
                               for n, g, r in zip(("dq", "dk", "dv"), out, refs)}
                         for src, out in zip(srcs, outs)}
            cost = c.flash_bwd_cost(q, k, v, causal)
            bound, by = c.bound_ms(*cost, c.FLASH_RATE[torch.float32][0])
            print(json.dumps({"f32_shape": label, "b_sq_sk_h_hk_d_causal": [b, sq, sk, h, hk, d,
                                                                            causal],
                              "kernel": name, "ms": ms,
                              "sdpa_backward_ms": c.sdpa_backward_ms(q, k, v, do, causal, n_iter=5),
                              "bound_ms": bound, "bound_by": by,
                              "cuda_core_bound_ms": c.bound_ms(*cost)[0],
                              "max_abs_err_from_plain_f64": plain_err,
                              "against_first": against_first(outs), "nvidia_smi": smi}),
                  flush=True)
            del q, k, v, o, lse, do, outs, refs
            torch.cuda.empty_cache()
    mod._lib_handle = None


if __name__ == "__main__":
    main()
