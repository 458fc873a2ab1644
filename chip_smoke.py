#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py           # every phase; exits non-zero on any failure
  python3 chip_smoke.py --quick   # device, build, kernels against plain at full width

Phases, one JSON line each:
  1. device   the card, its count, and nvidia-smi's name and power limit
  2. build    the three CUDA kernels from src/repro_torch/csrc, nvcc seconds,
              ptxas report, and flash attention's dynamic shared memory per head dim
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serve and prefill paths' full-width shapes and at the CPU tests' shapes
              (quantize_pages by both entries: contiguous pages, and the store into
              the tier pools, every pool tensor exact)
  4. path     the tiered serve step on the card against the same step on the CPU,
              from the same state, along 16 steps of a 2-layer model; then
              make_prefill and 8 make_serve_step steps the same way, at kv_bits
              16, 8 and 4; then one append and one raro_step at full width under
              torch.cuda.set_sync_debug_mode("error"): neither may make the host wait
  5. serve    launch.serve.run at tinyllama-1.1b's full widths and depth
              (random weights), RARO on and off, with the kernels' launch counts
              (exact), and the host syncs of one step of each, by source line
  6. prefill  make_prefill at tinyllama-1.1b's full widths and depth, batch 4,
              2048-token prompts, then 32 make_serve_step steps, at kv_bits 16, 8
              and 4: prefill ms, prompt tokens/s, decode ms/step, launch counts
  7. times    device time per launch of each kernel and its plain version (CUDA
              events, L2 flushed, the host's enqueue hidden behind a spin), the
              host's enqueue time, the least time the card could take (flash
              attention: on the 3xTF32 tensor cores, and on the CUDA cores beside
              it), a one-element op's time as the launch floor, and for flash
              attention one PyTorch call that computes the same function; the
              store path's whole calls (the store with its pool copies, append,
              raro_step): device ms, host enqueue ms, and ms per call back to back
  8. profile  torch.profiler over a few full-width RARO steps, and over one
              full-width prefill: the device's busy share and the kernels and host
              ops that take the time
  9. ssd      the SSD simulator (Layer A: ssdsim.state.init_state -> engine.run ->
              engine.summarize) on the card at the paper's Table III geometry:
              quickstart's three policies on 100,000 zipf-1.2 reads (closed loop),
              RARO under the lattice timing model at obs_level "full" on the same
              reads arriving open loop at 50,000 IOPS, and RARO on the endurance
              geometry under a fault storm (GC, relocation, retirement, program
              failures and uncorrectable reads with their rebuilds all firing). Each: the headline numbers, wall seconds and
              simulated requests per second, host syncs per chunk by source line,
              peak device memory, the device's busy share over a few profiled
              chunks, check_invariants on the final state, and the card held chunk
              by chunk against the port on the CPU (the first 16 chunks; the fault
              storm whole) by tests/torch_ssd_compare.py's rule. No kernel: the
              simulator's hot operations are plain PyTorch ops on the card
 10. sweep    the experiment sweep (experiments.sweep.run_sweep) on the card:
              (a) configs/raro_ssd.py's tail_latency_sweep() whole (Table III
              geometry, read_disturb_hammer, 80,000 requests, Baseline and RARO
              x P/E 166 and 833 x seeds 0 and 1): each run's headline numbers,
              the grid's and each group's wall seconds and simulated requests
              per second, every state on the card, RARO's read p99 below
              Baseline's, and a resume after the RARO group's checkpoint is
              deleted equal to the first run; (b) its RARO P/E 833 seed 0 run
              with its knobs on the card and on the CPU together, compared
              every 8th chunk and at the end, and the card's summary equal to
              the sweep's; (c) latency_load_sweep() at 16,384 requests: mean
              read latency never falls as the offered load rises; (d) the
              Chrome trace of the ssd phase's open-loop run, schema-checked
Then the `kernels` line and, last, the `ok` line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import raro_ssd, tinyllama_1_1b  # noqa: E402
from repro_torch.experiments import sweep as ssd_sweep  # noqa: E402
from repro_torch.core import modes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_fwd_plain)
# the store entry is read off these modules where it is used, so that the
# store path's timing and sync counts also run against a tree that lacks it
from repro_torch.kernels.quant_page import quant_page as qp, ref as qp_ref  # noqa: E402
from repro_torch.kernels.quant_page.quant_page import quantize_pages  # noqa: E402
from repro_torch.kernels.quant_page.ref import quant_pages_ref  # noqa: E402
from repro_torch.kernels.tiered_attention.tiered_attention import (  # noqa: E402
    tiered_decode_partial, tiered_decode_partial_plain)
from repro_torch.kvcache import paged, tiers  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import base, registry, transformer  # noqa: E402
from repro_torch.serving import serve_step  # noqa: E402
from repro_torch.ssdsim import engine as ssd_engine  # noqa: E402
from repro_torch.ssdsim import geometry as ssd_geometry  # noqa: E402
from repro_torch.ssdsim import obs as ssd_obs  # noqa: E402
from repro_torch.ssdsim import state as ssd_state  # noqa: E402
from repro_torch.ssdsim import trace_export  # noqa: E402
from repro_torch.ssdsim import workload as ssd_workload  # noqa: E402

sys.path.insert(0, str(ROOT / "tests"))
import torch_ssd_compare  # noqa: E402  (the Layer A comparison rule, numpy and torch only)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense
# flash attention's f32 products are 3xTF32: three TF32 products for each
FLASH_RATE = {torch.float32: (TF32_FLOP_PER_S / 3, "3xTF32 tensor cores, 495e12 / 3"),
              torch.bfloat16: (BF16_FLOP_PER_S, "bf16 tensor cores, 989e12")}
TOL = 1e-5  # kernel against plain, both in f32 on the card
# flash attention against its plain version: 1e-5 in f32; 2e-2 in bf16, where
# both round p and each tile's P.V to bf16 but at other points of the sums
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LOGITS_TOL = 1e-3  # a step on the card against the same step on the CPU

STEPS = 32  # decode steps of each full-width serve run: 4 pages committed per sequence
# the serve path's shapes at tinyllama-1.1b widths: batch 4, 32 heads over 4 KV
# heads of 64, pages of 8 tokens, max(STEPS // 8 + 2, 4) = 6 logical pages
FULL = dict(b=4, h=32, hk=4, d=64, p=8, mp=6)
# tests/test_kernels.py::TestTieredAttention shapes: (B, MP, P, Hk, G, D)
TEST_SHAPES = [(2, 6, 4, 2, 2, 16), (1, 4, 8, 1, 4, 32), (3, 8, 4, 4, 1, 64)]
# the serve path's (2B K and V pages), tests/test_kernels.py::TestQuantPage shapes,
# and shapes that reach the kernel's other paths: 8 and 32 elements a lane in
# registers, the streaming path with an odd-sized page, more heads than warps
QUANT_SHAPES = [(8, 8, 4, 64), (4, 16, 4, 32), (2, 64, 2, 128), (1, 8, 8, 64), (2, 4, 2, 64),
                (2, 16, 2, 64), (3, 5, 3, 6), (1, 8, 40, 16)]
# the store entry at the serve path's commit: B lanes of K and V pages (P, Hk, D)
# into pools of (8, 16, 256) pages; at the test shapes, 6 lanes into (5, 6, 9)
STORE_FULL = dict(b=4, p=8, hk=4, d=64, n=(8, 16, 256))

PROMPT = 2048  # tinyllama-1.1b's published context
# the prefill's attention at tinyllama-1.1b widths: (B, Sq, Sk, H, Hk, D, causal)
FLASH_FULL = (4, PROMPT, PROMPT, 32, 4, 64, True)
# tests/test_kernels.py::TestFlashAttention shapes, and one whose Sq and Sk are
# not multiples of the kernel's 64-row tiles, with GQA and no causal mask
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32, True), (1, 128, 128, 8, 2, 64, True),
                (2, 33, 95, 4, 1, 16, False), (1, 257, 300, 2, 2, 128, True),
                (3, 100, 170, 8, 2, 64, False)]

KERNELS = {
    "tiered_decode_partial": dict(
        route="cuda", source="src/repro_torch/csrc/tiered_attention.cu",
        replaces="src/repro/kernels/tiered_attention/tiered_attention.py:94"),
    "quantize_pages": dict(
        route="cuda", source="src/repro_torch/csrc/quant_page.cu",
        replaces="src/repro/kernels/quant_page/quant_page.py:43"),
    "flash_attention_fwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:63"),
}
COUNTERS = {"tiered_decode_partial": tiered_decode_partial, "quantize_pages": quantize_pages,
            "flash_attention_fwd": flash_attention_fwd}


def check(ok, msg):
    """Fail the run (a raise, which -O does not strip as it strips assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def reset_counts():
    for f in COUNTERS.values():
        f.launches = 0


def counts():
    return {name: f.launches for name, f in COUNTERS.items()}


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def slot_table(rng, b, mp, n, valid_per_seq):
    """(b, mp) int32: ``valid_per_seq`` distinct pool slots per row, -1 elsewhere."""
    t = np.full((b, mp), -1, np.int32)
    slots = rng.permutation(n)[: b * valid_per_seq].reshape(b, valid_per_seq)
    for i in range(b):
        t[i, rng.permutation(mp)[:valid_per_seq]] = slots[i]
    return t


def partial_inputs(rng, b, h, hk, d, p, mp, tier, pool_dtype, device, valid_per_seq=None):
    """Random q, pools, scales and slot table for one tier's partial."""
    n = max(b * mp, 8)
    valid = mp - 2 if valid_per_seq is None else valid_per_seq
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    if tier == modes.TIER_BF16:
        kv = [torch.tensor(rng.standard_normal((n, p, hk, d)).astype(np.float32)).to(pool_dtype)
              for _ in range(2)]
        sc = [torch.ones(n, hk) for _ in range(2)]
    else:
        dp = d if tier == modes.TIER_INT8 else d // 2
        kv = [torch.tensor(rng.integers(-128, 128, (n, p, hk, dp)).astype(np.int8))
              for _ in range(2)]
        sc = [torch.tensor((rng.random((n, hk)) * 0.05 + 1e-3).astype(np.float32))
              for _ in range(2)]
    st = torch.tensor(slot_table(rng, b, mp, n, valid))
    return [t.to(device) for t in (torch.tensor(q), kv[0], kv[1], sc[0], sc[1], st)]


def partial_cost(args, tier):
    """(bytes, flops) one launch needs for these inputs: q, the slot table, each
    valid page of K and V (and its scales) read once, every output written once."""
    q, kp, _, _, _, st = args
    b, h, d = q.shape
    _, p, hk, dp = kp.shape
    n_valid = int((st >= 0).sum())
    page_bytes = p * hk * dp * kp.element_size()
    scale_bytes = 0 if tier == modes.TIER_BF16 else hk * 4
    mp = st.shape[1]
    reads = q.numel() * 4 + st.numel() * 4 + n_valid * 2 * (page_bytes + scale_bytes)
    writes = 4 * (b * h * d + 2 * b * h + 2 * b * mp * h)
    # per valid page and query head: P*D multiply-adds for the scores and P*D for P.V
    return reads + writes, n_valid * h * 4 * p * d


def quant_cost(x, tier):
    n, p, hk, d = x.shape
    out_elems = n * p * hk * (d if tier == modes.TIER_INT8 else d // 2)
    bytes_ = x.numel() * x.element_size() + out_elems + n * hk * 4 + n * 4
    # absmax, divide, round, clip, dequantize, two squared sums: ~8 per element
    return bytes_, 8 * x.numel()


def store_inputs(rng, b, p, hk, d, n, page_dtype, pool0_dtype, device, tier=None, skip=()):
    """K and V pages (B, P, Hk, D), random pools of n = (n0, n1, n2) pages (so
    that a slot the store must leave alone shows), and per lane a tier (0, 1, 2,
    0, ... unless given) and a distinct slot of it; the lanes in ``skip`` get
    slot -1 and one past their pool's end, in turn. Returns (kpage, vpage,
    tier, slot) and the pools, in kvcache.paged's order."""
    pages = [torch.tensor(rng.standard_normal((b, p, hk, d)).astype(np.float32)).to(page_dtype)
             for _ in range(2)]
    pages[0].view(-1)[:4] = torch.tensor([0.5, -1.5, 2.5, -3.5])  # exact .5 ties
    tier = np.array([i % 3 for i in range(b)] if tier is None else tier, np.int32)
    free = [list(rng.permutation(k)) for k in n]
    slot = np.array([free[t].pop() for t in tier], np.int32)
    for j, i in enumerate(skip):
        slot[i] = -1 if j % 2 == 0 else n[tier[i]]

    def codes(rows, width):
        return torch.tensor(rng.integers(-128, 128, (rows, p, hk, width)).astype(np.int8))

    def scales(rows):
        return torch.tensor(rng.random((rows, hk)).astype(np.float32))

    pools = (*[torch.tensor(rng.standard_normal((n[0], p, hk, d)).astype(np.float32))
               .to(pool0_dtype) for _ in range(2)],
             codes(n[1], d), codes(n[1], d), scales(n[1]), scales(n[1]),
             codes(n[2], d // 2), codes(n[2], d // 2), scales(n[2]), scales(n[2]))
    lanes = (pages[0], pages[1], torch.tensor(tier), torch.tensor(slot))
    return [t.to(device) for t in lanes], tuple(t.to(device) for t in pools)


def store_cost(kpage, tier, slot, pools, tiers=(0, 1, 2)):
    """(bytes, flops) of one store launch for these inputs: the lanes' tiers and
    slots, and each stored lane's K and V pages, read once; its codes and
    scales, or its tier-0 copy, written once. Skipped lanes cost their tier and
    slot only."""
    b, p, hk, d = kpage.shape
    elems = p * hk * d
    tier, slot = tier.tolist(), slot.tolist()
    n = (pools[0].shape[0], pools[2].shape[0], pools[6].shape[0])
    stored = [t for t, s in zip(tier, slot) if t in tiers and 0 <= s < n[t]]
    out = {0: elems * pools[0].element_size(), 1: elems + hk * 4, 2: elems // 2 + hk * 4}
    bytes_ = 8 * b + sum(2 * (elems * kpage.element_size() + out[t]) for t in stored)
    # absmax, divide, round, clip and pack: ~5 per quantized element
    return bytes_, sum(2 * 5 * elems for t in stored if t > 0)


def flash_inputs(rng, b, sq, sk, h, hk, d, dtype, device):
    """Random q (B, Sq, H, D) and k, v (B, Sk, Hk, D) in ``dtype``."""
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)
            for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))]


def flash_cost(q, k, causal=True):
    """(bytes, flops) of one launch: q, k, v read once and o written once; per
    (query, key) pair the mask keeps, D multiply-adds for the score and D for
    P.V, at 2 operations each."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    bytes_ = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bytes_, 4 * d * b * h * pairs


def bound_ms(bytes_, flops, rate=F32_FLOP_PER_S):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    t0 = time.perf_counter()
    report = build.build(["tiered_attention", "quant_page", "flash_attention"])
    smem = build.load("flash_attention").flash_attention_smem_bytes
    smem.restype = ctypes.c_int
    flash_smem = {f"D{d} {dt}": smem(d, int(dt == "bf16")) for d in (16, 32, 64, 128)
                  for dt in ("f32", "bf16")}
    emit("build", seconds=time.perf_counter() - t0, report=report,
         flash_dynamic_smem_bytes=flash_smem)


def _max_err(outs, refs, names):
    errs = {}
    for name, a, r in zip(names, outs, refs):
        torch.testing.assert_close(a, r, atol=TOL, rtol=TOL, msg=lambda m: f"{name}: {m}")
        errs[name] = float((a - r).abs().max()) if a.numel() else 0.0
    return errs


def check_partial(dev, full_only):
    rng = np.random.default_rng(0)
    cases = [("full", FULL["b"], FULL["h"], FULL["hk"], FULL["d"], FULL["p"], FULL["mp"])]
    if not full_only:
        cases += [(f"test{i}", b, hk * g, hk, d, p, mp)
                  for i, (b, mp, p, hk, g, d) in enumerate(TEST_SHAPES)]
    worst = 0.0
    for label, b, h, hk, d, p, mp in cases:
        for tier, pool_dtype in ((0, torch.float32), (0, torch.bfloat16),
                                 (1, torch.int8), (2, torch.int8)):
            args = partial_inputs(rng, b, h, hk, d, p, mp, tier, pool_dtype, dev)
            out = tiered_decode_partial(*args, tier=tier)
            torch.cuda.synchronize()
            ref = tiered_decode_partial_plain(*args, tier=tier)
            errs = _max_err(out, ref, ("o", "m", "l", "page_p", "page_m"))
            skipped = args[5] < 0
            check(bool((out[3][skipped] == 0).all()) and bool((out[4][skipped] == -1e30).all()),
                  f"skipped pages must give page_p 0 and page_m -1e30 ({label}, tier {tier})")
            worst = max(worst, *errs.values())
            emit("kernels", kernel="tiered_decode_partial", shape=label, tier=tier,
                 pool=str(pool_dtype).replace("torch.", ""), max_abs_err=errs)
    return worst


def check_quant(dev, full_only):
    rng = np.random.default_rng(1)
    worst = 0.0
    for shape in QUANT_SHAPES[:1] if full_only else QUANT_SHAPES:
        for tier in (modes.TIER_INT8, modes.TIER_INT4):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(dt)
                x.view(-1)[:4] = torch.tensor([0.5, -1.5, 2.5, -3.5])  # exact .5 ties
                x = x.to(dev)
                q, s, e = quantize_pages(x, tier=tier)
                torch.cuda.synchronize()
                q_r, s_r, e_r = quant_pages_ref(x, tier=tier)
                check(torch.equal(q, q_r), f"codes differ at {shape} tier {tier} {dt}")
                check(torch.equal(s, s_r), f"scales differ at {shape} tier {tier} {dt}")
                torch.testing.assert_close(e[:, 0], e_r, rtol=TOL, atol=0)
                err = float((e[:, 0] - e_r).abs().max())
                worst = max(worst, err)
                emit("kernels", kernel="quantize_pages", shape=list(shape), tier=tier,
                     dtype=str(dt).replace("torch.", ""), codes_equal=True, scales_equal=True,
                     err_max_abs_err=err)
    check_store(dev, full_only)
    return worst


def check_store(dev, full_only):
    """The store entry against its plain version: lanes over tiers 0, 1 and 2
    and skipped lanes, f32 and bf16 pages and tier-0 pools, every tier or one;
    every pool tensor equal, untouched slots included, and the given pools left
    as they were."""
    rng = np.random.default_rng(6)
    f = STORE_FULL
    cases = [("full", f["b"], f["p"], f["hk"], f["d"], f["n"], (3,))]
    if not full_only:
        cases += [(f"test{i}", 6, p, hk, d, (5, 6, 9), (3, 4))
                  for i, (_, p, hk, d) in enumerate(QUANT_SHAPES[1:])]
    for label, b, p, hk, d, n, skip in cases:
        checked = 0
        for page_dt in (torch.float32, torch.bfloat16):
            for pool0_dt in (torch.float32, torch.bfloat16):
                for tiers_ in ((0, 1, 2), (1,), (2,)):
                    lanes, pools = store_inputs(rng, b, p, hk, d, n, page_dt, pool0_dt, dev,
                                                skip=skip)
                    before = [t.clone() for t in pools]
                    out = qp.quant_store_pages(*lanes, pools, tiers=tiers_)
                    torch.cuda.synchronize()
                    ref = qp_ref.quant_store_pages_ref(*lanes, pools, tiers=tiers_)
                    for i, (a, r) in enumerate(zip(out, ref)):
                        check(a.dtype == r.dtype and torch.equal(a, r),
                              f"store: pool {i} differs ({label}, pages {page_dt}, tier-0 "
                              f"pool {pool0_dt}, tiers {tiers_})")
                        check(torch.equal(pools[i], before[i]), f"store wrote pool {i} in place")
                    checked += 1
        emit("kernels", kernel="quantize_pages", entry="store", shape=label,
             b_p_hk_d=[b, p, hk, d], pool_pages=list(n), cases=checked, pools_equal=True)


def check_flash(dev, full_only):
    """The kernel against its plain version (with the kernel's KV blocks,
    so that both round p and each block's P.V at the same points), on both
    layouts it takes; a tail mask (sk_valid < Sk) on the reference's layout."""
    rng = np.random.default_rng(4)
    cases = [("full", FLASH_FULL, torch.float32)]
    if not full_only:
        cases += [(f"test{i}", shape, dt) for i, shape in enumerate(FLASH_SHAPES)
                  for dt in (torch.float32, torch.bfloat16)]
    worst = {}
    for label, (b, sq, sk, h, hk, d, causal), dt in cases:
        q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, dt, dev)
        heads_first = [t.transpose(1, 2).reshape(-1, t.shape[1], d) for t in (q, k, v)]
        sk_valid = sk - 5 if label != "full" else sk
        outs = [flash_attention_fwd(q, k, v, causal=causal),
                flash_attention_fwd(*heads_first, sk_valid=sk_valid, causal=causal)]
        torch.cuda.synchronize()
        bk = 32 if d == 128 else 64  # the kernel's KV tile
        refs = [flash_attention_fwd_plain(q, k, v, causal=causal, block_k=bk),
                flash_attention_fwd_plain(*heads_first, sk_valid=sk_valid, causal=causal,
                                          block_k=bk)]
        errs = {}
        for name, o, r in zip(("bshd", "bhsd_tail"), outs, refs):
            check(o.dtype == dt and o.shape == r.shape, f"{label} {name}: {o.dtype} {o.shape}")
            torch.testing.assert_close(o.float(), r.float(), atol=FLASH_TOL[dt],
                                       rtol=FLASH_TOL[dt], msg=lambda m: f"{label} {name}: {m}")
            errs[name] = float((o.float() - r.float()).abs().max())
        dname = str(dt).replace("torch.", "")
        worst[dname] = max(worst.get(dname, 0.0), *errs.values())
        emit("kernels", kernel="flash_attention_fwd", shape=label,
             b_sq_sk_h_hk_d_causal=[b, sq, sk, h, hk, d, causal], dtype=dname, sk_valid=sk_valid,
             tol=FLASH_TOL[dt], max_abs_err=errs)
    return worst


def to_device(caches, dev):
    return [paged.TieredKV(*[tuple(t.to(dev) for t in f) if isinstance(f, tuple) else f.to(dev)
                             for f in c]) for c in caches]


def phase_path(dev, steps=16, n_layers=2):
    """The serve step on the card against the CPU, from the same state each step."""
    cfg = serve.serve_cfg(n_layers=n_layers)
    ccfg = serve.cache_config(cfg, steps, 4)
    api = registry.get_api(cfg)
    p_cpu = base.materialize(api.specs(), torch.Generator().manual_seed(0), torch.float32, "cpu")
    p_dev = base.tree_map(lambda t: t.to(dev), p_cpu)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (steps, 4, 1)).astype(np.int32)
    worst = 0.0
    for rcfg in (tiers.RAROConfig(enabled=True), tiers.RAROConfig(enabled=False)):
        caches = [paged.init(ccfg, torch.float32, "cpu") for _ in range(cfg.n_layers)]
        tiers_seen = set()
        for t in range(steps):
            tok, pos = torch.tensor(tokens[t]), torch.full((4,), t, dtype=torch.int32)
            lg_c, next_c = serve.tiered_decode_step(p_cpu, caches, ccfg, rcfg, tok, pos, cfg)
            lg_d, next_d = serve.tiered_decode_step(p_dev, to_device(caches, dev), ccfg, rcfg,
                                                    tok.to(dev), pos.to(dev), cfg)
            torch.testing.assert_close(lg_d.cpu(), lg_c, atol=1e-3, rtol=0)
            worst = max(worst, float((lg_d.cpu() - lg_c).abs().max()))
            for cc, cd in zip(next_c, next_d):
                check(torch.equal(cd.tier.cpu(), cc.tier), f"tier table differs at step {t}")
                check(torch.equal(cd.slot.cpu(), cc.slot), f"slot table differs at step {t}")
                tiers_seen |= set(cc.tier.unique().tolist()) - {-1}
            caches = next_c
        emit("path", raro=rcfg.enabled, steps=steps, n_layers=n_layers,
             logits_max_abs_err=worst, tiers=sorted(tiers_seen))
    return worst


def host_syncs(fn):
    """fn's result, and each host sync it made (as "file:line" of the port's
    code that made it): set_sync_debug_mode("warn") turns each into a warning."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
                 if "called a synchronizing" in str(w.message)]


def full_width_cache(dev, cfg, rcfg):
    """One layer's cache at the serve path's shapes, its config and the
    generator, after all but the last token of a page went in (an append and a
    controller step each), from random K and V and no attention mass: the next
    append commits a cold page, to int4, in every sequence, which masses_like
    then heats enough that the controller promotes some."""
    ccfg = serve.cache_config(cfg, STEPS, FULL["b"])
    gen = torch.Generator(device=dev).manual_seed(7)
    c = paged.init(ccfg, torch.float32, dev)
    for _ in range(ccfg.page_size - 1):
        k, v = (torch.randn((ccfg.n_seqs, ccfg.n_kv_heads, ccfg.head_dim), generator=gen,
                            device=dev) for _ in range(2))
        c = paged.append(c, ccfg, k, v, tiers.commit_tier(c, ccfg, rcfg))
        c, _ = tiers.raro_step(c, ccfg, rcfg, torch.zeros_like(c.hot))
    return c, ccfg, gen


def masses_like(c, gen):
    """Random per-page attention masses, heavy enough to heat pages."""
    return torch.rand(c.hot.shape, generator=gen, device=c.hot.device) * 0.3


def phase_syncs(dev, cfg):
    """One commit_tier, append and raro_step of one layer at full width, RARO on,
    under set_sync_debug_mode("error"), in which every sequence commits a page,
    after the page's other tokens went in uncounted: any host sync raises. The
    core tables are made on the card in the uncounted part."""
    rcfg = tiers.RAROConfig()
    c, ccfg, gen = full_width_cache(dev, cfg, rcfg)
    k, v = (torch.randn((ccfg.n_seqs, ccfg.n_kv_heads, ccfg.head_dim), generator=gen, device=dev)
            for _ in range(2))
    masses = masses_like(c, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c = paged.append(c, ccfg, k, v, tiers.commit_tier(c, ccfg, rcfg))
        c, stats = tiers.raro_step(c, ccfg, rcfg, masses)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    committed = int((c.tier >= 0).sum())
    moved = {k: int(n) for k, n in stats.items()}
    check(committed == ccfg.n_seqs and sum(moved.values()) > 0,
          f"{committed} pages committed (want {ccfg.n_seqs}), {moved} moved (want some)")
    emit("syncs", check='set_sync_debug_mode("error")', calls=["commit_tier", "append",
                                                               "raro_step"],
         committed=committed, moved=moved, raised=False)


def step_syncs(dev, cfg, raro, batch=4, at_step=7):
    """Host syncs in one full-width tiered decode step (serve.tiered_decode_step,
    all layers), by source line: the 8th step, in which every sequence commits
    a page, after seven uncounted ones."""
    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              torch.float32, dev)
    ccfg = serve.cache_config(cfg, STEPS, batch)
    rcfg = tiers.RAROConfig(enabled=raro)
    caches = [paged.init(ccfg, torch.float32, dev) for _ in range(cfg.n_layers)]
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    for t in range(at_step + 1):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)

        def step():
            return serve.tiered_decode_step(params, caches, ccfg, rcfg, tok, pos, cfg)

        (logits, caches), syncs = host_syncs(step) if t == at_step else (step(), None)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    by_file = Counter(s.rsplit(":", 1)[0] for s in syncs)
    kv = sum(n for f, n in by_file.items() if "/kvcache/" in f)
    emit("syncs", path="serve.tiered_decode_step", arch=cfg.arch, n_layers=cfg.n_layers,
         raro=raro, step=at_step, syncs_per_step=len(syncs), from_kvcache=kv,
         by_file=dict(by_file.most_common()), by_line=dict(Counter(syncs).most_common(30)))
    return len(syncs), kv


class RecordLogits:
    """Within the block, every ``transformer.prefill`` and ``decode_step`` call
    (which the registry's entries, and so make_prefill and make_serve_step,
    reach) appends its logits to ``self.logits``."""

    def __init__(self):
        self.logits = []
        self.saved = {}

    def __enter__(self):
        for name in ("prefill", "decode_step"):
            fn = self.saved[name] = getattr(transformer, name)
            setattr(transformer, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def recorded(*a, **kw):
            logits, cache = fn(*a, **kw)
            self.logits.append(logits)
            return logits, cache
        return recorded

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(transformer, name, fn)


def pad_cache(cache, extra):
    """A prefill cache (exactly as long as the prompt; the reference decodes at
    pos % S) lengthened by ``extra`` positions: zero values or codes, scale ones.
    This caller's choice lets the decode steps follow the prompt."""
    return {n: torch.cat([t, (torch.ones_like if n.endswith("scale") else torch.zeros_like)(
        t[:, :, :extra])], dim=2) for n, t in cache.items()}


def same_tokens(tok_d, tok_c, logits_c):
    """Equal greedy tokens, except in a row whose two best logits on the CPU lie
    within LOGITS_TOL: there the card may rightly pick the other."""
    top2 = torch.topk(logits_c[:, -1].float(), 2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= LOGITS_TOL
    return bool(((tok_d.cpu() == tok_c) | near_tie).all()), int(near_tie.sum())


def phase_prefill_path(dev, steps=8, n_layers=2, prompt=64, batch=4):
    """make_prefill and make_serve_step on the card against the CPU, from the
    same state each step: logits within LOGITS_TOL, greedy tokens equal."""
    base_cfg = serve.serve_cfg(n_layers=n_layers)
    api = registry.get_api(base_cfg)
    p_cpu = base.materialize(api.specs(), torch.Generator().manual_seed(0), torch.float32, "cpu")
    p_dev = base.tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(5)
    tokens = torch.tensor(rng.integers(0, base_cfg.vocab, (batch, prompt)).astype(np.int32))
    for bits in (16, 8, 4):
        cfg = base_cfg.with_(kv_bits=bits)
        prefill, step = serve_step.make_prefill(cfg), serve_step.make_serve_step(cfg)
        worst, near_ties = 0.0, 0
        reset_counts()
        with RecordLogits() as rec:
            tok_c, cache_c = prefill(p_cpu, {"tokens": tokens})
            tok_d, _ = prefill(p_dev, {"tokens": tokens.to(dev)})
        n = counts()
        check(n["flash_attention_fwd"] == n_layers, f"prefill launches {n}, want {n_layers}")
        cache_c = pad_cache(cache_c, steps)
        for t in range(steps + 1):
            lg_c, lg_d = rec.logits[-2], rec.logits[-1].cpu()
            torch.testing.assert_close(lg_d, lg_c, atol=LOGITS_TOL, rtol=0)
            worst = max(worst, float((lg_d - lg_c).abs().max()))
            ok, ties = same_tokens(tok_d, tok_c, lg_c)
            check(ok, f"greedy tokens differ at kv_bits {bits}, step {t}")
            near_ties += ties
            if t == steps:
                break
            pos = torch.full((batch,), prompt + t, dtype=torch.int32)
            with rec:
                nxt_c, next_cache = step(p_cpu, cache_c, tok_c[:, None], pos)
                tok_d, _ = step(p_dev, {k: v.to(dev) for k, v in cache_c.items()},
                                tok_c[:, None].to(dev), pos.to(dev))
            tok_c, cache_c = nxt_c, next_cache
        emit("path", path="prefill+serve_step", kv_bits=bits, prompt=prompt, steps=steps,
             n_layers=n_layers, logits_max_abs_err=worst, near_ties=near_ties,
             flash_launches=n["flash_attention_fwd"])


def phase_prefill(dev, cfg, batch=4, prompt=PROMPT, steps=STEPS):
    """The prefill path at full width: make_prefill over ``batch`` random
    prompts, then ``steps`` make_serve_step steps from the padded cache, at each
    kv_bits. The counts are set to 0 just before the three runs and read just
    after them; each run's own counts are checked too."""
    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, dtype=torch.int32,
                           device=dev)
    # warm-up (cuBLAS handles, the kernels' first load), outside the counted runs
    tok, cache = serve_step.make_prefill(cfg)(params, {"tokens": tokens[:, :128]})
    serve_step.make_serve_step(cfg)(params, pad_cache(cache, 1), tok[:, None],
                                    torch.full((batch,), 128, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    total = dict.fromkeys(COUNTERS, 0)
    for bits in (16, 8, 4):
        c = cfg.with_(kv_bits=bits)
        prefill, step = serve_step.make_prefill(c), serve_step.make_serve_step(c)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with RecordLogits() as rec:
            t0 = time.perf_counter()
            tok, cache = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            n_prefill = counts()
            cache = pad_cache(cache, steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(steps):
                pos = torch.full((batch,), prompt + t, dtype=torch.int32, device=dev)
                tok, cache = step(params, cache, tok[:, None], pos)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        n = counts()
        for k in COUNTERS:
            total[k] += n[k]
        check(len(rec.logits) == steps + 1
              and bool(torch.stack([torch.isfinite(x).all() for x in rec.logits]).all()),
              f"non-finite logits at kv_bits {bits}")
        want = {"flash_attention_fwd": cfg.n_layers, "tiered_decode_partial": 0,
                "quantize_pages": 0}
        check(n_prefill == want and n == want,
              f"launches {n_prefill} in the prefill and {n} in the run, want {want}")
        check(cache["k"].shape[2] == prompt + steps
              and cache["k"].dtype == (torch.int8 if bits < 16 else torch.float32),
              f"cache {cache['k'].shape} {cache['k'].dtype} at kv_bits {bits}")
        emit("prefill", arch=cfg.arch, n_layers=cfg.n_layers, d_model=cfg.d_model, batch=batch,
             prompt=prompt, kv_bits=bits, steps=steps, prefill_ms=prefill_s * 1e3,
             prompt_tokens_per_s=batch * prompt / prefill_s,
             decode_ms_per_step=decode_s * 1e3 / steps, launches=n,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    return total


def phase_serve(dev, cfg, steps, batch):
    """launch.serve.run at full width, RARO on then off; the counts are set to 0
    just before each run and read just after it, and must be exact: per layer
    and step, three partials, and one store launch in append plus, with RARO,
    one in each of raro_step's three moves into int8 or int4. Then the host
    syncs of one step of each."""
    finite = []
    step = serve.tiered_decode_step

    def checked_step(*a, **kw):  # every step's logits must be finite
        logits, caches = step(*a, **kw)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    serve.tiered_decode_step = checked_step
    runs = {}
    try:
        for raro in (True, False):
            finite.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out = serve.run(steps=steps, batch=batch, raro_enabled=raro, cfg=cfg, quiet=True,
                            device=dev)
            torch.cuda.synchronize()
            n = counts()
            check(len(finite) == steps and bool(torch.stack(finite).all()), "non-finite logits")
            want = {"tiered_decode_partial": 3 * cfg.n_layers * steps,
                    "quantize_pages": (4 if raro else 1) * cfg.n_layers * steps,
                    "flash_attention_fwd": 0}
            check(n == want, f"launches {n}, want {want}")
            check(all(math.isfinite(out[k]) for k in ("mean_prob_drift", "final_prob_drift")),
                  f"drift is not finite: {out}")
            if raro:
                check(sum(v > 0 for v in out["tier_pages"]) >= 2,
                      f"RARO left pages in fewer than two tiers: {out['tier_pages']}")
            runs[raro] = n
            emit("serve", arch=cfg.arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 steps=steps, batch=batch, raro=raro, result=out, launches=n,
                 launches_per_step={k: v / steps for k, v in n.items()},
                 max_memory_allocated=torch.cuda.max_memory_allocated())
    finally:
        serve.tiered_decode_step = step
    for raro in (True, False):
        step_syncs(dev, cfg, raro, batch)
    return runs


def profiled(fn):
    """(wall ms, device ms by name, host ms by name, inclusive) of one call of
    ``fn`` under torch.profiler. The device is busy for the summed duration of
    its kernels and copies (one stream, so they do not overlap); the profiler's
    own cost lengthens the wall time, so the busy share it gives is a lower
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, cpu_ms = {}, {}
    for e in prof.events():
        dur = e.time_range.elapsed_us() / 1e3
        table = device_ms if e.device_type == DeviceType.CUDA else cpu_ms
        table[e.name] = table.get(e.name, 0.0) + dur
    return wall_ms, device_ms, cpu_ms


def top(table, per, n=8):
    return [[k, v / per] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def phase_profile(dev, cfg, steps=4, batch=4):
    """Where a full-width RARO step spends its time: a short run after a warm-up one."""
    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              torch.float32, dev)
    serve.run(steps=2, batch=batch, cfg=cfg, params=params, quiet=True, device=dev)
    torch.cuda.synchronize()
    wall_ms, device_ms, cpu_ms = profiled(lambda: serve.run(
        steps=steps, batch=batch, cfg=cfg, params=params, quiet=True, device=dev))
    busy = sum(device_ms.values())
    emit("profile", path="serve", arch=cfg.arch, raro=True, steps=steps, batch=batch,
         wall_ms_per_step=wall_ms / steps,
         device_busy_ms_per_step=busy / steps if busy else None,
         device_busy_share=busy / wall_ms if busy else None,
         top_device_ms_per_step=top(device_ms, steps),
         top_host_inclusive_ms_per_step=top(cpu_ms, steps))


def phase_profile_prefill(dev, cfg, batch=4, prompt=PROMPT):
    """Where one full-width prefill (kv_bits 16) spends its time, after a warm-up one."""
    api = registry.get_api(cfg)
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0),
                              torch.float32, dev)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prefill = serve_step.make_prefill(cfg)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall_ms, device_ms, cpu_ms = profiled(lambda: prefill(params, {"tokens": tokens}))
    busy = sum(device_ms.values())
    emit("profile", path="prefill", arch=cfg.arch, batch=batch, prompt=prompt, wall_ms=wall_ms,
         device_busy_ms=busy or None, device_busy_share=busy / wall_ms if busy else None,
         top_device_ms=top(device_ms, 1, 10), top_host_inclusive_ms=top(cpu_ms, 1, 10))


def time_launches(fn, n_iter=50, warmup=5):
    """(device ms, host ms) per call. Each call is timed alone by CUDA events,
    with the L2 cache flushed (a 256 MB write) before it. The card is first held
    in a spin (``torch.cuda._sleep``) for about three times the host's time per
    call, so the host enqueues the whole call behind it and the events time the
    device's work only; the host's enqueue time is taken on its own clock."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = int(max((time.perf_counter() - t0) / warmup, 1e-4) * 3 * 2e9)  # clocks <= 2 GHz
    device_ms = host_s = 0.0
    for _ in range(n_iter):
        flush.zero_()
        torch.cuda._sleep(cycles)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        fn()
        host_s += time.perf_counter() - t
        b.record()
        b.synchronize()
        device_ms += a.elapsed_time(b)
    return device_ms / n_iter, host_s * 1e3 / n_iter


def time_call(fn, n_iter=20):
    """A whole call: device ms and host enqueue ms as time_launches takes them
    (for a call that syncs, the device time takes in the waits on the host, and
    the host time the wait on the spin), and ms per call with calls back to
    back, host clock, ended by a synchronize: what a loop of them costs."""
    device_ms, host_ms = time_launches(fn, n_iter=n_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    torch.cuda.synchronize()
    return dict(device_ms=device_ms, host_ms=host_ms,
                loop_ms=(time.perf_counter() - t0) * 1e3 / n_iter)


def time_store(dev, floor_ms=None):
    """The store path at the serve shape: the store entry's kernel alone and its
    plain version (append's commit: lanes of tiers 0, 1, 2, 2, f32 pages); the
    whole store call, its pool copies included, for that commit and for a move
    of 4 bf16 pages into int4; and whole append (a committing one) and
    raro_step calls of one layer. On a tree without the store entry the whole
    store calls are its ``_store_page``: three for a commit, one for a move.
    Returns the kernel's row for the ``kernels`` line (None without it)."""
    if floor_ms is None:
        one = torch.zeros(1, device=dev)
        floor_ms, _ = time_launches(lambda: one.add_(1))
    rng = np.random.default_rng(8)
    f = STORE_FULL
    has_store = hasattr(qp, "quant_store_pages")
    commit, pools = store_inputs(rng, f["b"], f["p"], f["hk"], f["d"], f["n"], torch.float32,
                                 torch.float32, dev, tier=(0, 1, 2, 2))
    move, _ = store_inputs(rng, f["b"], f["p"], f["hk"], f["d"], f["n"], torch.bfloat16,
                           torch.float32, dev, tier=(2, 2, 2, 2))
    row = None
    bytes_, flops = store_cost(commit[0], commit[2], commit[3], pools)
    bnd, by = bound_ms(bytes_, flops)
    if has_store:
        out = [t.clone() for t in pools]
        fn = qp._kernel("quant_store_pages_launch")
        k, v, tier, slot = commit
        args = ([t.data_ptr() for t in (k, v, tier, slot, *out)]
                + [f["b"], f["p"], f["hk"], f["d"], *f["n"], 0, 0, 0b111,
                   torch.cuda.current_stream(dev).cuda_stream])
        check(fn(*args) == 0, "store kernel launch failed")
        ms, host_ms = time_launches(lambda: fn(*args))
        plain, plain_host_ms = time_launches(lambda: qp_ref.quant_store_pages_ref(*commit, pools))
        emit("times", kernel="quantize_pages", entry="store", lanes_tiers=[0, 1, 2, 2],
             b_p_hk_d=[f["b"], f["p"], f["hk"], f["d"]], pool_pages=list(f["n"]), ms=ms,
             host_ms=host_ms, plain_ms=plain, plain_host_ms=plain_host_ms, bytes=bytes_,
             flops=flops, bound_ms=bnd, bound_by=by, launch_floor_ms=floor_ms, library="none")
        row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)

        def commit_call():
            return qp.quant_store_pages(*commit, pools)

        def move_call():
            return qp.quant_store_pages(*move, pools, tiers=(2,))
        impl = "quant_store_pages"
    else:
        def commit_call():
            out = pools
            for t in range(3):
                out = paged._store_page(out, t, torch.where(commit[2] == t, commit[3], -1),
                                        commit[0], commit[1])
            return out

        def move_call():
            return paged._store_page(pools, 2, move[3], move[0], move[1])
        impl = "paged._store_page"
    # a functional store also copies each pool it hands back anew
    for name, call, lanes, written in (("store: append's commit", commit_call, commit, range(10)),
                                       ("store: a move into int4", move_call, move, range(6, 10))):
        b_, f_ = store_cost(lanes[0], lanes[2], lanes[3], pools)
        b_ += 2 * sum(pools[i].numel() * pools[i].element_size() for i in written)
        emit("times", call=name, impl=impl, **time_call(call), bytes=b_,
             bound_ms=bound_ms(b_, f_)[0], launch_floor_ms=floor_ms)
    rcfg = tiers.RAROConfig()
    c, ccfg, gen = full_width_cache(dev, tinyllama_1_1b.CONFIG, rcfg)
    k, v = (torch.randn((ccfg.n_seqs, ccfg.n_kv_heads, ccfg.head_dim), generator=gen, device=dev)
            for _ in range(2))
    ct = tiers.commit_tier(c, ccfg, rcfg)
    committed = paged.append(c, ccfg, k, v, ct)
    masses = masses_like(c, gen)
    for name, call in (("append (commits a page per sequence)",
                        lambda: paged.append(c, ccfg, k, v, ct)),
                       ("raro_step", lambda: tiers.raro_step(committed, ccfg, rcfg, masses))):
        emit("times", call=name, layer="one, tinyllama-1.1b widths", **time_call(call),
             launch_floor_ms=floor_ms)
    return row


def phase_times(dev):
    rng = np.random.default_rng(3)
    out = {}
    rows = []
    # what any launch costs, timed the same way: one PyTorch op on one element
    one = torch.zeros(1, device=dev)
    floor_ms, floor_host_ms = time_launches(lambda: one.add_(1))
    emit("times", kernel="launch_floor", op="add_ on a 1-element tensor", ms=floor_ms,
         host_ms=floor_host_ms)
    # the three launches of one layer's decode step: tier 0 (an f32 pool, as the
    # serve path holds it), int8 and int4, each with 4 of 6 pages valid per sequence
    # (32 steps commit 4 pages)
    for tier, dt in ((0, torch.float32), (1, torch.int8), (2, torch.int8)):
        args = partial_inputs(rng, **FULL, tier=tier, pool_dtype=dt, device=dev, valid_per_seq=4)
        ms, host_ms = time_launches(lambda: tiered_decode_partial(*args, tier=tier))
        plain, plain_host_ms = time_launches(lambda: tiered_decode_partial_plain(*args, tier=tier))
        bytes_, flops = partial_cost(args, tier)
        rows.append(dict(ms=ms, plain_ms=plain, bytes=bytes_, flops=flops))
        bnd, by = bound_ms(bytes_, flops)
        emit("times", kernel="tiered_decode_partial", tier=tier, ms=ms, host_ms=host_ms,
             plain_ms=plain, plain_host_ms=plain_host_ms, bytes=bytes_, flops=flops,
             bound_ms=bnd, bound_by=by, launch_floor_ms=floor_ms, library="none")
    out["tiered_decode_partial"] = _mean_row(rows)
    rows = []
    # the contiguous entry: the K and V pages of a batch of 4, f32
    for tier in (modes.TIER_INT8, modes.TIER_INT4):
        x = torch.tensor(rng.standard_normal(QUANT_SHAPES[0]).astype(np.float32)).to(dev)
        ms, host_ms = time_launches(lambda: quantize_pages(x, tier=tier))
        plain, plain_host_ms = time_launches(lambda: quant_pages_ref(x, tier=tier))
        bytes_, flops = quant_cost(x, tier)
        rows.append(dict(ms=ms, plain_ms=plain, bytes=bytes_, flops=flops))
        bnd, by = bound_ms(bytes_, flops)
        emit("times", kernel="quantize_pages", entry="contiguous", tier=tier,
             shape=list(x.shape), ms=ms,
             host_ms=host_ms, plain_ms=plain, plain_host_ms=plain_host_ms, bytes=bytes_,
             flops=flops, bound_ms=bnd, bound_by=by, launch_floor_ms=floor_ms, library="none")
    # the main path reaches it by the store entry: the kernels line takes that row
    out["quantize_pages"] = time_store(dev, floor_ms)

    # one launch of the prefill's attention at full width, f32 as the path runs it
    b, sq, sk, h, hk, d, causal = FLASH_FULL
    q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, torch.float32, dev)
    ms, host_ms = time_launches(lambda: flash_attention_fwd(q, k, v, causal=causal), n_iter=20)
    plain, plain_host_ms = time_launches(
        lambda: flash_attention_fwd_plain(q, k, v, causal=causal), n_iter=5, warmup=2)
    # the yardstick, never called by the port: PyTorch's own fused attention on
    # the same f32 tensors in its (B, H, S, D) layout
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                                enable_gqa=True)

    lib_ms, lib_host_ms = time_launches(library, n_iter=20)
    lib_err = float((library().transpose(1, 2) - flash_attention_fwd(q, k, v, causal=causal))
                    .abs().max())
    bytes_, flops = flash_cost(q, k, causal)
    rate, rate_name = FLASH_RATE[q.dtype]
    bnd, by = bound_ms(bytes_, flops, rate)
    core_bnd, core_by = bound_ms(bytes_, flops)  # PR 12's bound, on the CUDA cores
    emit("times", kernel="flash_attention_fwd", shape=list(FLASH_FULL), dtype="float32", ms=ms,
         host_ms=host_ms, plain_ms=plain, plain_host_ms=plain_host_ms, bytes=bytes_, flops=flops,
         bound_ms=bnd, bound_by=by, bound_rate=rate_name, cuda_core_bound_ms=core_bnd,
         cuda_core_bound_by=core_by, launch_floor_ms=floor_ms,
         library="torch.nn.functional.scaled_dot_product_attention",
         library_ms=lib_ms, library_host_ms=lib_host_ms, library_max_abs_err=lib_err)
    out["flash_attention_fwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=lib_ms)
    return out


SSD_REQUESTS = 100_000  # quickstart's default
SSD_CMP_CHUNKS = 16  # chunks of (a)-RARO and (b) held against the CPU
SSD_SYNC_CHUNKS = 8  # chunks whose host syncs are counted
SSD_PROFILE_CHUNKS = 4  # chunks under the profiler


def ssd_runs():
    """The ssd phase's runs: (name, config, trace, chunks held against the
    CPU: 0 none, None all)."""
    G = ssd_geometry
    runs = []
    for pol in (G.BASELINE, G.HOTNESS, G.RARO):  # (a) examples/quickstart.py
        cfg = replace(raro_ssd.MIDDLE, policy=pol)
        runs.append((f"a_{G.POLICY_NAMES[pol]}", cfg,
                     ssd_workload.zipf_read_trace(cfg, SSD_REQUESTS, 1.2, seed=1),
                     SSD_CMP_CHUNKS if pol == G.RARO else 0))
    # (b) experiments/scenarios.py::zipf_openloop's defaults (seed 0)
    cfg = replace(raro_ssd.MIDDLE, chan_model="lattice", obs_level="full")
    trace = ssd_workload.attach_arrivals(
        cfg, ssd_workload.zipf_read_trace(cfg, SSD_REQUESTS, 1.2, seed=0), 50_000.0, seed=1)
    runs.append(("b_raro_lattice_openloop_50k", cfg, trace, SSD_CMP_CHUNKS))
    # (c) configs/raro_ssd.py's endurance geometry, old stage, fault_storm's
    # trace at fault_storm_sweep's rates, parity rebuild, 16 spares, lifespan GC
    storm = raro_ssd.fault_storm_sweep()
    cfg = replace(raro_ssd.endurance_sweep().base, policy=G.RARO,
                  initial_pe=raro_ssd.OLD.initial_pe, prog_fail_rate=storm.prog_fail_rate[-1],
                  erase_fail_rate=storm.erase_fail_rate[0],
                  max_read_retries=storm.max_read_retries[0], parity_rebuild=True,
                  spare_blocks=16, gc_objective="lifespan")
    trace = ssd_workload.mixed_trace(cfg, 24_576, 1.2, read_frac=0.3, write_theta=2.0, seed=0)
    runs.append(("c_raro_endurance_fault_storm", cfg, trace, None))
    return runs


def _ssd_chunks(trace, n=None):
    """The trace's chunks as tuples of CPU tensors (the first ``n``)."""
    return ssd_engine.trace_chunks({k: v[:n] for k, v in trace.items()}, "cpu")


def ssd_lockstep(cfg, trace, n_chunks, dev, knobs=None, every=1):
    """The card against the port on the CPU, step by step from the same
    trace (and ``knobs``, a ``RunKnobs`` on the CPU, as a sweep run takes
    them): both states and chunk metrics compared after every ``every``-th
    chunk and the last by the comparison rule (the first divergence, its
    chunk and leaves, is kept), then both summaries; check_invariants on both
    final states."""
    C = torch_ssd_compare
    chunks = _ssd_chunks(trace, n_chunks)
    has_writes = bool((trace["op"][:len(chunks)] == ssd_engine.OP_WRITE).any())
    knobs_d = None if knobs is None else type(knobs)(
        *[None if k is None else k.to(dev) for k in knobs])
    init = {} if knobs is None else dict(initial_pe=knobs.initial_pe,
                                         spare_blocks=knobs.spare_blocks)
    s_c = ssd_state.init_state(cfg, device="cpu", **init)
    s_d = ssd_state.init_state(cfg, device=dev, **init)
    first, lattice = None, cfg.chan_model == "lattice" and "arrival_ms" in trace
    compared = 0
    for c, req in enumerate(chunks):
        s_c, y_c = ssd_engine.step_chunk(s_c, req, cfg, has_writes, knobs)
        s_d, y_d = ssd_engine.step_chunk(s_d, tuple(x.to(dev) for x in req), cfg, has_writes,
                                         knobs_d)
        if (c + 1) % every and c + 1 < len(chunks):
            continue
        compared += 1
        if first is None:
            loose = C.lindley_loose(s_c.obs_lat_mode.numpy()) if lattice else {}
            bad = (C.compare_leaves(ssd_state.SSDState._fields, s_c, s_d, loose=loose)
                   + C.compare_leaves(ssd_engine.ChunkMetrics._fields, y_c, y_d,
                                      where="metrics."))
            if bad:
                first = dict(chunk=c, leaves=bad[:6])
    ssd_state.check_invariants(s_c, cfg, "cpu")
    ssd_state.check_invariants(s_d, cfg, "card")
    loose = C.lindley_loose(s_c.obs_lat_mode.numpy()) if lattice else {}
    summ_c, summ_d = ssd_engine.summarize(s_c, cfg), ssd_engine.summarize(s_d, cfg)
    bad_summary = C.compare_summaries(summ_c, summ_d, loose=loose)
    return dict(chunks=len(chunks), compared=compared, first_divergence=first,
                summary_mismatches=bad_summary), summ_d


def phase_ssd(dev):
    """Layer A on the card (see the module docstring, phase 9). Returns the
    summaries, and the open-loop run's (config, final state) by name."""
    out, states = {}, {}
    for name, cfg, trace, cmp_chunks in ssd_runs():
        n_chunks = trace["lpn"].shape[0]
        if not out:  # a short warm-up run: the first run pays one-time costs
            ssd_engine.run(cfg, {k: v[:2] for k, v in trace.items()}, device=dev)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s, m = ssd_engine.run(cfg, trace, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(s.clock_ms.device.type == "cuda", f"{name}: the state is not on the card")
        ssd_state.check_invariants(s, cfg, name)
        summ = ssd_engine.summarize(s, cfg)
        check(all(math.isfinite(v) for v in summ.values() if isinstance(v, float)),
              f"{name}: a summary value is not finite")
        check(int(m.reads.sum()) == int(summ["reads"]) and summ["reads"] > 0,
              f"{name}: chunk reads do not add up to the run's")
        if name.startswith("c_"):
            check(summ["erases"] > 0 and summ["prog_fails"] > 0 and summ["bad_blocks"] > 0,
                  f"{name}: the fault storm did not fire GC and faults: {summ['erases']} "
                  f"erases, {summ['prog_fails']} prog fails, {summ['bad_blocks']} bad blocks")

        # host syncs of the first chunks (their trace upload included), by line
        prefix = {k: v[:SSD_SYNC_CHUNKS] for k, v in trace.items()}
        (s8, _), syncs = host_syncs(lambda: ssd_engine.run(cfg, prefix, device=dev))
        per_chunk = {k: v / SSD_SYNC_CHUNKS for k, v in Counter(syncs).most_common()}

        # the device's busy share over a few chunks after those
        chunks = _ssd_chunks(trace)[SSD_SYNC_CHUNKS:SSD_SYNC_CHUNKS + SSD_PROFILE_CHUNKS]
        has_writes = bool((trace["op"] == ssd_engine.OP_WRITE).any())

        def steps(state=s8):
            for req in chunks:
                state, _ = ssd_engine.step_chunk(state, tuple(x.to(dev) for x in req), cfg,
                                                 has_writes)

        wall_ms, device_ms, cpu_ms = profiled(steps)
        busy = sum(device_ms.values())

        cmp = None
        if cmp_chunks != 0:
            cmp, _ = ssd_lockstep(cfg, trace, cmp_chunks, dev)
            check(cmp["first_divergence"] is None and not cmp["summary_mismatches"],
                  f"{name}: the card diverges from the CPU: {cmp}")
        out[name] = summ
        if name.startswith("b_"):
            states[name] = (cfg, s)
        emit("ssd", run=name, n_blocks=cfg.n_blocks, n_slots=cfg.n_slots,
             n_logical=cfg.n_logical, chunk=cfg.chunk, chunks=n_chunks,
             requests=int(trace["lpn"].size), open_loop="arrival_ms" in trace,
             chan_model=cfg.chan_model, obs_level=cfg.obs_level,
             **{k: summ[k] for k in ("iops", "retries_per_read", "capacity_loss_gib",
                                     "migrated_pages", "erases", "read_lat_p99_us")},
             faults={k: summ[k] for k in ("uncorrectable_reads", "prog_fails", "erase_fails",
                                          "bad_blocks", "rebuilds", "data_loss",
                                          "dropped_writes")},
             wall_s=wall, sim_requests_per_s=trace["lpn"].size / wall,
             host_syncs_per_chunk=sum(per_chunk.values()), host_syncs_by_line=per_chunk,
             max_memory_allocated=peak,
             profile=dict(chunks=len(chunks), wall_ms=wall_ms, device_busy_ms=busy,
                          device_busy_share=busy / wall_ms if busy else None,
                          top_device_ms=top(device_ms, 1, 6),
                          top_host_inclusive_ms=top(cpu_ms, 1, 6)),
             card_vs_cpu=cmp)
    b, h, r = (out[f"a_{n}"] for n in ("baseline", "hotness", "raro"))
    emit("ssd", quickstart_ratios=dict(
        raro_over_baseline_iops=r["iops"] / b["iops"],
        raro_over_hotness_capacity_loss_saved=1 - r["capacity_loss_gib"]
        / max(h["capacity_loss_gib"], 1e-9)))
    return out, states


SWEEP_DIR = ROOT / "build" / "chip_smoke_sweep"  # git-ignored
SWEEP_CMP_EVERY = 8  # (b) compares the card with the CPU every 8th chunk and at the end
SWEEP_LOAD_REQUESTS = 16_384  # (c): latency_load_sweep's 80,000 cut to fit the script's time


class StepWatch:
    """While active, wraps ``engine.step_chunk`` (which ``sweep.run_one``
    calls): counts the steps of each policy group, times each group from its
    first step to its last (a synchronize after each step), and counts the
    state and knob tensors that are not on the card."""

    def __init__(self):
        self.steps, self.first, self.last, self.off_card = Counter(), {}, {}, 0

    def __enter__(self):
        self.real = ssd_engine.step_chunk

        def step(s, req, cfg, has_writes, knobs=None):
            t0 = time.perf_counter()
            out = self.real(s, req, cfg, has_writes, knobs)
            torch.cuda.synchronize()
            name = ssd_geometry.POLICY_NAMES[cfg.policy]
            self.first.setdefault(name, t0)
            self.last[name] = time.perf_counter()
            self.steps[name] += 1
            leaves = list(out[0]) + [k for k in (knobs or ()) if isinstance(k, torch.Tensor)]
            self.off_card += sum(x.device.type != "cuda" for x in leaves)
            return out

        ssd_engine.step_chunk = step
        return self

    def __exit__(self, *exc):
        ssd_engine.step_chunk = self.real

    def group_s(self, name):
        return self.last[name] - self.first[name]


def _sweep_row(r):
    return dict(tag=r["run"]["tag"], **{k: r[k] for k in (
        "iops", "mean_read_latency_us", "read_lat_p50_us", "read_lat_p99_us",
        "read_lat_p999_us", "retries_per_read", "migrated_pages", "capacity_loss_gib")})


def chrome_trace_schema(doc, cfg, s):
    """tests/test_obs.py's Chrome-trace checks (test_schema, and
    test_event_slices_match_ring against the event ring of state ``s``)."""
    evs = doc["traceEvents"]
    body = [e for e in evs if e["ph"] != "M"]
    check(body, "the Chrome trace has no events")
    for e in evs:
        check(e["ph"] in ("M", "X", "C") and isinstance(e["pid"], int)
              and isinstance(e["tid"], int), f"bad trace event {e}")
        if e["ph"] == "X":
            check(e["ts"] >= 0 and e["dur"] > 0 and e["pid"] == trace_export.PID_FLASH
                  and 0 <= e["tid"] <= trace_export.policy_tid(cfg), f"bad slice {e}")
        if e["ph"] == "C":
            check(e["pid"] == trace_export.PID_TELEMETRY, f"bad counter {e}")
    ts = [e["ts"] for e in body]
    check(all(a <= b for a, b in zip(ts, ts[1:])), "trace ts not monotone")
    names = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    check({f"die {d} (chan {cfg.channel_of_die(d)})" for d in range(cfg.n_dies)} <= names
          and {f"channel {c} bus" for c in range(cfg.n_channels)} <= names
          and "policy (page-granular)" in names, f"trace tracks missing: {names}")
    x = [e for e in body if e["ph"] == "X"]
    reloc = [e for e in x if e["cat"] == "relocation"]
    xfer = [e for e in x if e["cat"] == "transfer"]
    check(all(cfg.n_dies <= e["tid"] < cfg.n_dies + cfg.n_channels for e in xfer),
          "a transfer slice is off the channel tracks")
    records, total, _ = ssd_obs.decode_events(s, cfg)
    check(len(reloc) == len(records) and doc["otherData"]["events_total"] == total
          and len(xfer) == sum(r["block"] >= 0 and r["pages"] > 0 for r in records),
          f"trace slices {len(reloc)}/{len(xfer)} against {len(records)} ring events")
    return dict(events=len(evs), slices=len(x), relocations=len(reloc), transfers=len(xfer),
                counters=sum(e["ph"] == "C" for e in body))


def phase_sweep(dev, b_cfg, b_state):
    """The experiment sweep on the card (see the module docstring, phase 10).
    ``b_cfg`` and ``b_state`` are the ssd phase's open-loop run, for (d)."""
    G = ssd_geometry
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)  # a fresh grid: no checkpoint of an earlier run
    reset_counts()

    # (a) the canonical tail-latency grid, whole, with per-group checkpoints
    spec = raro_ssd.tail_latency_sweep()
    resume = SWEEP_DIR / "tail_latency"
    n_chunks = -(-spec.n_requests // spec.base.chunk)
    t0 = time.perf_counter()
    with StepWatch() as watch:
        res = ssd_sweep.run_sweep(spec, resume_dir=resume)
    wall = time.perf_counter() - t0
    per_group = len(res) // len(spec.policies)
    check(len(res) == spec.n_runs() == 8, f"{len(res)} results for an 8-run grid")
    check(dict(watch.steps) == {G.POLICY_NAMES[p]: per_group * n_chunks for p in spec.policies},
          f"steps by group {dict(watch.steps)}, not {per_group} x {n_chunks}")
    check(watch.off_card == 0, f"{watch.off_card} state or knob tensors left the card")
    for r in res:
        check(all(math.isfinite(v) for v in r.values() if isinstance(v, float)),
              f"{r['run']['tag']}: a result is not finite")
        check(r["reads"] == spec.n_requests, f"{r['run']['tag']}: {r['reads']} reads")
    by = {r["run"]["tag"]: r for r in res}
    p99 = {}
    for pe in spec.initial_pe:
        for seed in spec.seeds:
            b, r = (by[f"{spec.scenario}_{p}_pe{pe}_seed{seed}"] for p in ("baseline", "raro"))
            p99[f"pe{pe}_seed{seed}"] = [b["read_lat_p99_us"], r["read_lat_p99_us"]]
            check(r["read_lat_p99_us"] < b["read_lat_p99_us"],
                  f"RARO's read p99 is not below Baseline's at P/E {pe} seed {seed}: "
                  f"{r['read_lat_p99_us']} vs {b['read_lat_p99_us']}")
    reqs = spec.n_requests * per_group
    emit("sweep", part="a_grid", spec=dict(scenario=spec.scenario, n_requests=spec.n_requests,
                                           initial_pe=spec.initial_pe, seeds=spec.seeds,
                                           n_blocks=spec.base.n_blocks,
                                           n_slots=spec.base.n_slots,
                                           n_logical=spec.base.n_logical, chunk=spec.base.chunk),
         runs=len(res), chunks_per_run=n_chunks, wall_s=wall,
         sim_requests_per_s=len(res) * spec.n_requests / wall,
         groups={name: dict(runs=per_group, wall_s=watch.group_s(name),
                            sim_requests_per_s=reqs / watch.group_s(name))
                 for name in watch.steps},
         p99_baseline_raro_us=p99, states_off_card=watch.off_card)
    for r in res:
        emit("sweep", part="a_run", **_sweep_row(r))

    # (a) a partial resume: the RARO group recomputed on the card, Baseline loaded
    raro_ckpt = ssd_sweep._group_ckpt_path(resume, spec, G.RARO)
    check(raro_ckpt.exists() and ssd_sweep._group_ckpt_path(resume, spec, G.BASELINE).exists(),
          "the grid wrote no checkpoints")
    raro_ckpt.unlink()
    t0 = time.perf_counter()
    with StepWatch() as again:
        res2 = ssd_sweep.run_sweep(spec, resume_dir=resume)
    wall2 = time.perf_counter() - t0
    check(dict(again.steps) == {"raro": per_group * n_chunks},
          f"the resume stepped {dict(again.steps)}, not RARO's group alone")
    ssd_sweep.assert_results_identical(res, res2)
    emit("sweep", part="a_partial_resume", recomputed="raro", loaded="baseline", wall_s=wall2,
         identical=True)

    # (b) one run of the grid with its knobs: the card against the CPU, whole
    run = next(r for r in ssd_sweep.expand(spec)
               if r.policy == G.RARO and r.initial_pe == 833 and r.seed == 0)
    trace = ssd_sweep.registry.build(spec.scenario, spec.base, spec.n_requests, seed=run.seed)
    knobs = ssd_sweep.run_knobs(run, spec, open_loop=False, device="cpu")
    t0 = time.perf_counter()
    cmp, summ_d = ssd_lockstep(replace(spec.base, policy=G.RARO), trace, None, dev,
                               knobs=knobs, every=SWEEP_CMP_EVERY)
    check(cmp["first_divergence"] is None and not cmp["summary_mismatches"],
          f"{run.tag()}: the card diverges from the CPU: {cmp}")
    check(cmp["chunks"] == n_chunks, f"(b) stepped {cmp['chunks']} of {n_chunks} chunks")
    swept = by[run.tag()]
    ssd_sweep.assert_results_identical([swept], [dict(summ_d, run=swept["run"])])
    emit("sweep", part="b_card_vs_cpu", tag=run.tag(), card_vs_cpu=cmp,
         card_summary_equals_sweep=True, wall_s=time.perf_counter() - t0)

    # (c) the open-loop knob: offered load swept through RunKnobs.arrival_scale
    load = raro_ssd.latency_load_sweep(n_requests=SWEEP_LOAD_REQUESTS)
    t0 = time.perf_counter()
    with StepWatch() as lw:
        lres = ssd_sweep.run_sweep(load)
    lwall = time.perf_counter() - t0
    check(lw.off_card == 0, f"{lw.off_card} state or knob tensors left the card")
    curves = {}
    for pol in load.policies:
        name = G.POLICY_NAMES[pol]
        rows = [r for r in lres if r["run"]["policy"] == name]
        check([r["run"]["arrival_scale"] for r in rows] == list(load.arrival_scale),
              f"{name}: arrival_scale {[r['run']['arrival_scale'] for r in rows]}")
        mean = [r["mean_read_latency_us"] for r in rows]
        check(all(a <= b for a, b in zip(mean, mean[1:])),
              f"{name}: mean read latency falls as the offered load rises: {mean}")
        curves[name] = [dict(arrival_scale=r["run"]["arrival_scale"],
                             mean_read_latency_us=r["mean_read_latency_us"],
                             read_lat_p99_us=r["read_lat_p99_us"],
                             read_queue_delay_us=r["read_queue_delay_us"], iops=r["iops"])
                        for r in rows]
    emit("sweep", part="c_latency_load", scenario=load.scenario,
         n_requests=load.n_requests, cut="n_requests 80,000 -> 16,384 (the script's time)",
         rate_iops=dict(load.scenario_kw)["rate_iops"], runs=len(lres), wall_s=lwall,
         sim_requests_per_s=len(lres) * load.n_requests / lwall, curves=curves)

    # (d) the Chrome trace of the ssd phase's open-loop lattice run
    path = trace_export.write_chrome_trace(b_state, b_cfg, SWEEP_DIR / "trace_b_lattice.json")
    schema = chrome_trace_schema(json.loads(path.read_text()), b_cfg, b_state)
    emit("sweep", part="d_chrome_trace", path=str(path.relative_to(ROOT)),
         bytes=path.stat().st_size, **schema)
    emit("sweep", kernel_launches=counts())


def _mean_row(rows):
    """One launch, averaged over the tiers timed: its times and its bound."""
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
    bnd, by = bound_ms(mean["bytes"], mean["flops"])
    return dict(ms=mean["ms"], plain_ms=mean["plain_ms"], bound_ms=bnd, bound_by=by)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build, and each kernel against plain at full width only "
                         "(no path, serve, prefill, times, profile, ssd or sweep phase)")
    a = ap.parse_args()

    phase_device()
    dev = torch.device("cuda")
    phase_build()
    errs = {"tiered_decode_partial": check_partial(dev, a.quick),
            "quantize_pages": check_quant(dev, a.quick),
            "flash_attention_fwd": check_flash(dev, a.quick)}
    emit("kernels", max_abs_err=errs)
    if not a.quick:
        cfg = tinyllama_1_1b.CONFIG
        phase_path(dev)
        phase_prefill_path(dev)
        phase_syncs(dev, cfg)
        runs = phase_serve(dev, cfg, STEPS, 4)
        launches = {k: runs[True][k] for k in ("tiered_decode_partial", "quantize_pages")}
        launches["flash_attention_fwd"] = phase_prefill(dev, cfg)["flash_attention_fwd"]
        times = phase_times(dev)  # before the profiler, whose cost outlasts its window
        phase_profile(dev, cfg)
        phase_profile_prefill(dev, cfg)
        _, ssd_states = phase_ssd(dev)
        phase_sweep(dev, *ssd_states["b_raro_lattice_openloop_50k"])
        flash_err = errs["flash_attention_fwd"]
        errs["flash_attention_fwd"] = max(flash_err.values())
        print(json.dumps({"kernels": [
            dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errs[k],
                 ms=times[k]["ms"], plain_ms=times[k]["plain_ms"], bound_ms=times[k]["bound_ms"],
                 bound_by=times[k]["bound_by"], library_ms=times[k].get("library_ms"))
            for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
