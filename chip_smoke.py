#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py           # every phase; exits non-zero on any failure
  python3 chip_smoke.py --quick   # device, build, kernels against plain at full width

Phases, one JSON line each (and after each, a ``phase_seconds`` line with its
name and wall seconds; their total on the line before the last):
  1. device   the card, its count, and nvidia-smi's name and power limit
  2. build    the five CUDA sources from src/repro_torch/csrc, nvcc seconds,
              ptxas report (registers, spills), and flash attention's forward's
              and backward's dynamic shared memory per pair of head dims
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serve and prefill paths' full-width shapes (flash attention also at
              granite-moe-3b-a800m's, 24 heads over 8, at deepseek-v3-671b's
              MLA prefill, 128 heads with q and k 192 wide over v 128 wide, and
              at whisper-medium's encoder (1500 frames) and cross-attention (416
              queries over 1500 frames), both without the causal mask, f32 and
              bf16, and a ragged MLA case; and at the rank-local heads of the
              parallel phase's tensor-parallel training) and at the CPU tests' shapes
              (quantize_pages by both entries: contiguous pages, and the store into
              the tier pools, every pool tensor exact); ordered_scatter_add bit for
              bit against the CPU's serial index_add_ on the same lanes, at the obs
              sums' rows (64 x 9 and 192 x 6) and 1, 128 and 1,024 lanes, with
              duplicates and drops, every lane to one row, every lane dropped;
              flash attention's backward (kernels for Delta, dK and dV, dQ)
              against its plain version on the same q, k, v, output, log-sum-exp
              and cotangent, f32 within 1e-5 and bf16 within 2^-6 of each
              gradient's largest plain entry, two calls bit-equal, at every
              training shape above (tinyllama's, granite's, MLA's at B 1 x 1024
              and ragged, whisper's three, and the tensor-parallel ranks')
  4. path     the tiered serve step on the card against the same step on the CPU,
              from the same state, along 16 steps of a 2-layer model; then
              make_prefill and 8 make_serve_step steps the same way, at kv_bits
              16, 8 and 4; then one append and one raro_step at full width under
              torch.cuda.set_sync_debug_mode("error"): neither may make the host wait
  5. serve    launch.serve.run at tinyllama-1.1b's full widths and depth
              (random weights), RARO on and off, with the kernels' launch counts
              (exact), and the host syncs of one step of each, by source line
 5b. policy   the RARO KV-tier controller (commit_tier, append, raro_step) through
              quant_store_pages: tests/test_kvcache_policy.py's six cases (cold
              pages stay int4, hot pages promoted, a disabled controller static,
              retry estimates grow with reads, elastic demotion under pressure,
              capacity accounting) at the test's CacheConfig and at
              tinyllama-1.1b's serve widths (4 KV heads of 64, the serve phase's
              page size and pools, batch 4), each on the card and on the CPU from
              the same numpy draws: every cache leaf, the moves and the retry
              estimates equal, the test's assertion on the card's state, and
              exactly one store launch per append and per quantizing move
  6. prefill  make_prefill at tinyllama-1.1b's full widths and depth, batch 4,
              2048-token prompts, then 32 make_serve_step steps, at kv_bits 16, 8
              and 4: prefill ms, prompt tokens/s, decode ms/step, launch counts
  7. times    device time per launch of each kernel and its plain version (CUDA
              events, L2 flushed, the host's enqueue hidden behind a spin), the
              host's enqueue time, the least time the card could take (flash
              attention: on the 3xTF32 tensor cores, and on the CUDA cores beside
              it), a one-element op's time as the launch floor, and for flash
              attention (tinyllama's shape in f32, granite's, MLA's and
              whisper's encoder and cross-attention in bf16)
              one PyTorch call that computes the same function; the
              store path's whole calls (the store with its pool copies, append,
              raro_step): device ms, host enqueue ms, and ms per call back to back
  8. profile  torch.profiler over a few full-width RARO steps, and over one
              full-width prefill: the device's busy share and the kernels and host
              ops that take the time
  9. train    training tinyllama-1.1b (launch.train, training.train_step, AdamW,
              checkpoints): (a) one make_train_step step of a 2-layer model at
              full widths in f32 on the card against the CPU, the same numpy-made
              parameters and batch (loss, grad norm, every updated parameter and
              moment); (b) the flash kernel's autograd entry (kernel forward with
              its log-sum-exp, kernel backward) against the plain attention's
              autograd at the training shape in f32 (taken exactly, in f64) and
              bf16 (blockwise_attention), the kernel's refusal
              of inputs that require grad, and the times of the forward, the
              forward with its log-sum-exp, the backward kernels beside their
              bound, the plain backward and PyTorch's fused attention's backward;
              (c) the main path, launch.train.run at full width and depth (bf16,
              remat, batch 4 x 2048 tokens, 8 steps): loss and grad norm per step,
              ms per step, tokens/s, peak memory, exactly 44 flash forward and 22
              backward launches a step, and a profiled step; (d) a 2-layer run
              resumed from its step-3 checkpoint, its losses equal to an
              uninterrupted run's bit for bit
 10. moe      the MoE family at granite-moe-3b-a800m's widths (32 layers, d_model
              1536, 24 heads over 8 of 64, 40 experts top-8 of width 512; 3.30 B
              parameters): (a) 2 layers in f32, make_prefill and 8 make_serve_step
              steps on the card against the CPU from the same state each step
              (logits and the prefill's cache within 1e-3, greedy tokens equal), and
              one loss and gradient (loss and grad norm within 1e-5 relative), with
              the smallest router top-k margin met; (b) the main serving path at full
              depth in bf16: make_prefill over 4 x 2048 tokens, then 32
              make_serve_step steps: prefill ms, decode tokens/s, peak memory, flash
              launches (exactly 32 per prefill, 0 per decode step), host syncs of a
              decode step; (c) the main training path, launch.train.run at full
              width and depth (bf16, router f32, remat, batch 4 x 2048, 8 steps):
              ms per step, tokens/s, peak memory, exactly 64 flash forward and 32
              backward launches a step, finite losses and grad norms, a profiled
              step; (d) a profiled decode
              step: the top device ops and the device's busy share
 11. ssd      the SSD simulator (Layer A: ssdsim.state.init_state -> engine.run ->
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
              storm whole) by tests/torch_ssd_compare.py's rule (the open-loop
              run's obs_lat_comp by lindley_loose but for the components no
              Lindley sum feeds); (d) tests/test_torch_wearout.py's parity-rebuild
              cell (tiny geometry, obs_level "full", 8,192 reads) in lockstep, card
              against CPU, every chunk by the strict rule and obs_ts and
              obs_lat_comp bit for bit, after the same run with the former one-hot
              sums, whose gaps are printed. The obs float sums run the
              ordered_scatter_add kernel (2 launches a chunk at obs_level "full",
              1 at "counters", counted per run); the rest are plain PyTorch ops
 12. sweep    the experiment sweep (experiments.sweep.run_sweep) on the card:
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
 13. mla      deepseek-v3-671b (MLA: q_lora_rank 1536, kv_lora_rank 512, q and k
              heads of 192 over v heads of 128; 256 experts top-8 of width 2048,
              one shared; dense first layers of width 18432; MTP; vocab 129280):
              (a) 2 layers (1 dense, 1 MoE, the routed experts cut to 16) at the
              published widths in f32, make_prefill over 2 x 64 tokens and 8
              make_serve_step steps on the card against the CPU from the same
              state each step (logits and the latent caches within 1e-3, greedy
              tokens equal), and one loss_fn forward, MTP included (1e-5
              relative); (b) the main serving path at the published widths in
              bf16 at 4 layers (3 dense, 1 MoE of all 256 experts; 14.87 B
              parameters): make_prefill over 4 x 2048 tokens, then 32
              make_serve_step steps: prefill ms, decode tokens/s, peak memory of
              the init and of serving, flash launches (exactly 4 per prefill, 0
              per decode step), host syncs of a decode step, and a profiled
              decode step; (c) the flash kernel's autograd entry against the
              plain attention's autograd at MLA's shape (B 1, S 1024, H 128),
              f32 (taken exactly, in f64) and bf16
 14. families the last three families at their published widths: whisper-medium
              (encdec: 24 encoder and 24 decoder layers, d_model 1024, 16 heads of
              64, 1500 frames), xlstm-125m (ssm: 12 layers, every 4th sLSTM) and
              zamba2-2.7b (hybrid: 54 Mamba2 layers, a shared attention block
              after every 9). (a) Each at its widths with its depth cut (whisper
              2 + 2 layers, xlstm 4, zamba2 10: one shared-attention application
              and a tail without) in f32: make_prefill over 2 x 64 tokens (and
              1500 frames) and 8 make_serve_step steps on the card against the
              CPU from the same state each step (logits, KV caches and every
              recurrent state within 1e-3, greedy tokens equal), and one loss_fn
              forward (1e-5 relative). (b) The main serving path at full width
              and depth in bf16 (the recurrent states f32), batch 4: whisper over
              1500 frames and a 416-token prompt, xlstm and zamba2 over 1024
              tokens (their prefill a host step per token), then 32
              make_serve_step steps: prefill ms, decode ms per
              step, tokens/s, peak memory, flash launches (exactly 72 per whisper
              prefill, 0 per decode step, 0 for xlstm and zamba2), host syncs of a
              decode step, a profiled prefill (64 tokens for the recurrent
              families, whose per-token work the host issues) and a profiled
              decode step. (c) The flash kernel's autograd entry at whisper's
              encoder (B 4 x 1500 x 1500) and cross (416 x 1500) shapes, non-causal,
              against the plain attention's gradients in f32 (exact, f64) and bf16,
              and its refusal of inputs that require grad; (d) one make_train_step
              step of each family at (a)'s cut depth in f32 on 2 x 32 tokens, card
              against CPU from the same numpy-made parameters and batch, held as
              train (a) holds tinyllama.
              Frames and tokens are drawn by numpy from --seed
 15. dryrun   the dry run on the meta device (python -m repro_torch.launch.dryrun)
              held against the card: (a) the whole dry run (ten archs x four
              shapes x the 16x16, 2x16x16 and h100_1x1 meshes, seven processes):
              cells ok, skipped and failed per mesh, and the h100_1x1 fit table
              (per-device bytes, estimated peak, fits); (b) each arch whose
              parameters fit the card, one cell per kind (train_4k, prefill_32k,
              decode_32k) at published widths and depth with global_batch cut to 1
              (xlstm's and zamba2's train and prefill to 512 tokens), and every
              whole cell that fits: each cell the dry run rules out printed with
              its bytes; each other run on the card, its materialized arguments'
              bytes equal to the dry run's per-device argument bytes, the FLOPs
              counted on the card equal to the meta count (but where a recurrence
              loops per token), max_memory_allocated beside the estimate (and
              the bytes requested at the peak within cuBLAS's workspace of the
              live bytes tracked on the card, which holds dryrun.inside_bytes to
              what kernels allocate inside), max_memory_reserved, achieved
              TFLOP/s and the flash launches; all under the caching allocator's
              default settings, as the port's entry points run
 16. parallel the parallel layer at runtime over a one-rank NCCL group on the card
              (one H100 holds one rank; several ranks are held on the CPU over
              gloo by tests/test_torch_parallel.py and test_torch_runtime.py):
              (a) the group started from a file:// rendezvous under build/, and
              launch.mesh.make_mesh((1, 1), ("data", "model")) over it; (b)
              launch.train.run of tinyllama-1.1b at the train phase's shape (bf16,
              remat, batch 4 x 2048), 4 steps with mesh=None before the group
              starts and 4 on the mesh: losses and final parameters bit-equal
              (on one data rank the step skips its data mean, the identity), 44
              flash launches a step, ms per step of both; then that mean itself,
              collectives.mean_over over the NCCL group on the loss and gradients
              of one step at the final parameters, bit-equal to its input, and
              its ms; (c) moe.moe_apply_ep
              at granite-moe-3b-a800m's widths (40 experts top-8, d_model 1536,
              moe_d_ff 512) on 4 x 2048 tokens, tp = 1, forward and backward,
              against moe.moe_apply at capacity factor E / K where neither drops
              (checked from the routing), f32 within 1e-5 and bf16 within 2e-2 of
              each tensor's largest entry; ms of both and the all_to_all share;
              (d) compression.compressed_allreduce over each gradient leaf of one
              tinyllama-1.1b step, without and with error feedback: the mean
              bit-equal to decompress(compress(g)), the residual to the CPU's; ms
              and the bytes on the wire against f32; (e) experiments.sweep's
              run_sweep on devices=("cuda:0", "cuda:0") (a thread each) for the
              canonical grid's RARO group at 16,384 requests, identical to one
              device; (f) tensor parallelism: two processes on the one card in a
              gloo group (NCCL refuses two ranks on one GPU; gloo carries CUDA
              tensors through the host) on the (1, 2) mesh, launch.train.run
              placing tinyllama-1.1b's parameters by the sharding rules: (f1) 2
              layers in f32, 2 steps of 2 x 256, losses, each step's grad norm
              and the gathered final parameters against one process within the
              CPU tests' tolerances;
              (f2) the full model in bf16, 3 steps of 2 x 2048, losses within
              2e-3 of one process's, 44 flash launches a step on each rank at its
              16 heads over 2 KV heads, each rank's parameter, gradient and AdamW
              bytes and peak memory beside one process's, ms a step and the host
              ms inside gloo's all-reduces (one card: not tensor-parallel speed);
              (g) the other families the same way on (1, 2), whisper-medium,
              deepseek-v3-671b (MLA, dense-first layers, MTP), xlstm-125m and
              zamba2-2.7b, each after its one-process runs, each through
              launch.train.run(cfg=, mesh=) (whisper's step built as run builds
              it, on batches that carry its frames): (g1) at cut depth in f32, 2
              steps, the losses, each step's grad norm and each rank's blocks of
              the final parameters against one process within (f1)'s
              tolerances; (g2) at full widths in bf16 (deepseek-v3 at its 3 dense
              layers and MTP, zamba2 at 9 layers, the recurrent two on short
              sequences), 2 steps: losses within 2e-3 of one process's, each
              rank's parameter, gradient and AdamW bytes equal to the dry run's per-device bytes
              on the (1, 2) mesh, its peak beside one process's, ms a step,
              gloo's all-reduce and all-gather calls and host ms, and the flash
              launches of each step at the rank's heads (whisper 144, deepseek-v3
              7; the kernel is held at those rank-local shapes in `kernels`);
              (h) MoE over two data ranks: granite-moe-3b-a800m at its published
              widths cut to 2 MoE layers, f32, capacity factor 0.5, on the (2, 1)
              mesh, two processes of 2 x 256 tokens against one process on the
              whole batch: the loss within 1e-5, each gradient leaf within 1e-5 of
              its largest entry, assignments dropped (the ranks' drops adding up
              to the one process's), ms a step and gloo's share
Then the `kernels` line (every kernel launched on its main path), the phases'
seconds and, last, the `ok` line.
"""

from __future__ import annotations

import argparse
import contextlib
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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import ops as port_ops  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ShapeConfig, deepseek_v3_671b, granite_moe_3b_a800m, raro_ssd, tinyllama_1_1b, whisper_medium,
    xlstm_125m, zamba2_2_7b)
from repro_torch.experiments import sweep as ssd_sweep  # noqa: E402
from repro_torch.core import hotness, modes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention_fwd, flash_attention_fwd_lse, flash_attention_fwd_plain,
    kernel_block_k)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_bwd_flops, kernel_bwd_block)
# the store entry is read off these modules where it is used, so that the
# store path's timing and sync counts also run against a tree that lacks it
from repro_torch.kernels.quant_page import quant_page as qp, ref as qp_ref  # noqa: E402
from repro_torch.kernels.quant_page.quant_page import quantize_pages  # noqa: E402
from repro_torch.kernels.quant_page.ref import quant_pages_ref  # noqa: E402
from repro_torch.kernels.tiered_attention.tiered_attention import (  # noqa: E402
    tiered_decode_partial, tiered_decode_partial_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention_train  # noqa: E402
from repro_torch.kernels.ordered_scatter_add.ordered_scatter_add import (  # noqa: E402
    ordered_scatter_add, ordered_scatter_add_plain)
from repro_torch.kvcache import paged, tiers  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh, init_distributed, make_host_mesh, make_mesh, set_mesh)
from repro_torch.models import (  # noqa: E402
    attention as attn, base, encdec, hybrid, moe, registry, transformer, xlstm)
from repro_torch.serving import serve_step  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.parallel import collectives, compression, sharding  # noqa: E402
from repro_torch.training import optim, train_step  # noqa: E402
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
# check_flash's bf16 atol is at most 2^-6 x the largest |plain output|, 2 to 4
# bf16 ulps of it: the two part by one ulp of the output at most (9.8e-4 at
# whisper's shapes, where |o| peaks near 0.2 and 2e-2 would be a tenth of it)
FLASH_BF16_ATOL_OF_MAX = 2.0 ** -6
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
# granite-moe-3b-a800m's prefill and training attention: 24 query heads over 8
# KV heads (a group of 3), bf16 as its serving and training paths run it
FLASH_GRANITE = (4, PROMPT, PROMPT, 24, 8, 64, True)
# deepseek-v3-671b's MLA prefill: 128 heads (no GQA), q and k 192 wide (nope 128
# + rope 64), v 128 wide (V_DIM), v a strided slice of the expanded latent
FLASH_MLA = (4, PROMPT, PROMPT, 128, 128, 192, True)
# a ragged MLA case: Sq and Sk not multiples of the tiles, tail-masked on the
# reference's (B·H, S, D) layout
FLASH_MLA_RAGGED = (2, 300, 333, 8, 8, 192, True)
# whisper-medium's prefill at batch 4, 16 heads of 64 (no GQA): the encoder's
# self-attention over its 1500 frames, the decoder's causal self-attention over
# a 416-token prompt, and its cross-attention from the prompt to the frames
# (Sq != Sk); 1500 and 416 are not multiples of the kernel's 128-row tiles
FLASH_WHISPER_ENC = (4, 1500, 1500, 16, 16, 64, False)
FLASH_WHISPER_DEC = (4, 416, 416, 16, 16, 64, True)
FLASH_WHISPER_CROSS = (4, 416, 1500, 16, 16, 64, False)
WHISPER_FLASH = {"whisper_enc": FLASH_WHISPER_ENC, "whisper_dec": FLASH_WHISPER_DEC,
                 "whisper_cross": FLASH_WHISPER_CROSS}
# the autograd entry at MLA's shape (the flash kernel forward, the plain backward)
FLASH_MLA_TRAIN = (1, 1024, 1024, 128, 128, 192, True)
V_DIM = dict(HEAD_DIMS)  # the v head dim the kernel pairs with each q and k head dim
# tinyllama-1.1b's training attention on one rank of a model axis of 2, 4 and 8
# (its 32 heads over 4 KV heads split over the ranks; at 4 and 8 the KV heads do
# not divide the axis, and each rank keeps the one its queries read), batch 2 x
# 2048; and a rank whose two query heads straddle two KV groups (12 heads over 4
# on 6 ranks), its KV heads expanded to one for each query head
FLASH_TP = {"tp2": (2, PROMPT, PROMPT, 16, 2, 64, True), "tp4": (2, PROMPT, PROMPT, 8, 1, 64, True),
            "tp8": (2, PROMPT, PROMPT, 4, 1, 64, True),
            "tp_expanded_kv": (2, PROMPT, PROMPT, 2, 2, 64, True)}
# the rank-local attention of (g2) in the parallel phase, on one rank of a model
# axis of 2: whisper-medium's encoder, decoder and cross-attention at 8 of its 16
# heads (batch 2, 1500 frames, 416 tokens), and deepseek-v3-671b's MLA at 64 of
# its 128 heads (q and k 192 wide over v 128 wide; batch 1 x 2048)
FLASH_TP_FAMILIES = {"tp2_whisper_enc": (2, 1500, 1500, 8, 8, 64, False),
                     "tp2_whisper_dec": (2, 416, 416, 8, 8, 64, True),
                     "tp2_whisper_cross": (2, 416, 1500, 8, 8, 64, False),
                     "tp2_mla": (1, PROMPT, PROMPT, 64, 64, 192, True)}
# tests/test_kernels.py::TestFlashAttention shapes, and one whose Sq and Sk are
# not multiples of the kernel's 128-row tiles, with GQA and no causal mask
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32, True), (1, 128, 128, 8, 2, 64, True),
                (2, 33, 95, 4, 1, 16, False), (1, 257, 300, 2, 2, 128, True),
                (3, 100, 170, 8, 2, 64, False)]

# the simulator's float observability sums (ssdsim/obs.py::record_reads), one
# chunk of reads at a time: the time series obs_ts (64 windows x 9 series) and
# the component sums obs_lat_comp as (3 modes x 64 bins, 6 components) rows;
# lanes: one, the tiny geometry's chunk (128) and Table III's (1,024)
ORDERED_ROWS = {"obs_ts": (64, 9), "obs_lat_comp": (3 * 64, 6)}
ORDERED_LANES = (1, 128, 1024)
ORDERED_TIME_LANES = 1024  # the main path's chunk (Table III geometry)
# the kernel's other paths: rows of 128 (four columns a thread), more lanes
# than one tile of shared memory holds, rows wider than a warp, no lanes
ORDERED_EDGES = [(7, 128, 300), (5, 1, 9000), (300, 33, 2000), (3, 2, 0)]

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
    "ordered_scatter_add": dict(
        route="cuda", source="src/repro_torch/csrc/ordered_scatter_add.cu",
        replaces="no Pallas kernel: the reference's drop-mode scatter-adds "
                 "src/repro/ssdsim/obs.py:192 and :218 (record_reads)"),
    "flash_attention_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="no Pallas kernel: the reference's training gradient, XLA's autodiff of "
                 "blockwise_attention src/repro/models/attention.py:27 (its flash kernel "
                 "src/repro/kernels/flash_attention/flash_attention.py:63 is forward only)"),
}
COUNTERS = {"tiered_decode_partial": tiered_decode_partial, "quantize_pages": quantize_pages,
            "flash_attention_fwd": flash_attention_fwd, "ordered_scatter_add": ordered_scatter_add,
            "flash_attention_bwd": flash_attention_bwd}
# flash_attention_bwd's launches by main path (a training step's), filled in
# by the phases that run one, each read right after its run
BWD_BY_PATH: dict = {}


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


def normal(rng, shape, dtype, device):
    """Standard normal draws of ``shape`` in ``dtype``, made on ``device`` by a
    generator seeded from the numpy ``rng`` (the flash checks' large inputs:
    drawing them on the host took tens of seconds a run)."""
    g = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    return torch.randn(shape, generator=g, device=device).to(dtype)


def flash_inputs(rng, b, sq, sk, h, hk, d, dtype, device):
    """Random q (B, Sq, H, D), k (B, Sk, Hk, D) and v (B, Sk, Hk, Dv) in
    ``dtype``, Dv = V_DIM[d]. Where Dv < D, v is the second half of a (B, Sk,
    Hk, 2 Dv) tensor, strided as MLA's prefill hands it over."""
    dv = V_DIM[d]
    q, k, kv = [normal(rng, shape, dtype, device)
                for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, dv if dv == d else 2 * dv))]
    return q, k, kv[..., -dv:]


def flash_cost(q, k, v, causal=True):
    """(bytes, flops) of one launch: q, k, v read once and o written once; per
    (query, key) pair the mask keeps, D multiply-adds for the score and Dv for
    P.V, at 2 operations each."""
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    bytes_ = (q.numel() + k.numel() + v.numel() + q.numel() // d * dv) * q.element_size()
    return bytes_, 2 * (d + dv) * b * h * pairs


def flash_bwd_cost(q, k, v, causal=True):
    """(bytes, flops) of one backward call: q, k, v, the output, its
    cotangent and the log-sum-exp read once, dq, dk and dv written once; the
    five products per kept (query, key) pair (``flash_bwd_flops``)."""
    b, sq, h, d = q.shape
    o = b * sq * h * v.shape[-1]
    bytes_ = (2 * (q.numel() + k.numel() + v.numel()) + 2 * o) * q.element_size() + b * h * sq * 4
    return bytes_, flash_bwd_flops(q.shape, v.shape, k.shape[1], causal)


def ordered_inputs(rng, rows, cols, lanes, dev, how="mixed"):
    """dst (rows, cols), idx (lanes,) int64 and src (lanes, cols), float32 of
    mixed magnitudes, so that the order of the adds shows in the rounding.
    ``how``: "mixed" indices with duplicates and drops (as ``ops.drop_index``
    leaves them: a dropped lane names row ``rows``); "one_row" every lane to
    row 1; "dropped" every lane past the end."""
    dst = (rng.standard_normal((rows, cols)) * 1e3).astype(np.float32)
    src = (rng.standard_normal((lanes, cols))
           * 10.0 ** rng.integers(-4, 5, (lanes, cols))).astype(np.float32)
    idx = {"mixed": rng.integers(0, rows + 1, lanes), "one_row": np.ones(lanes),
           "dropped": np.full(lanes, rows)}[how].astype(np.int64)
    return [torch.from_numpy(a).to(dev) for a in (dst, idx, src)]


def ordered_cost(dst, idx, src):
    """(bytes, flops) of one launch: dst, idx and src read once, the output
    written once; one add per element of each lane kept."""
    kept = int(((idx >= 0) & (idx < dst.shape[0])).sum())
    bytes_ = 2 * dst.numel() * 4 + idx.numel() * 8 + src.numel() * 4
    return bytes_, kept * src.shape[1]


def bound_ms(bytes_, flops, rate=F32_FLOP_PER_S):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_device():
    """The card, and nvidia-smi's "name, power limit" of it, which is returned."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    t0 = time.perf_counter()
    report = build.build(["tiered_attention", "quant_page", "flash_attention",
                          "ordered_scatter_add", "flash_attention_bwd"])
    smem = build.load("flash_attention").flash_attention_smem_bytes
    smem.restype = ctypes.c_int
    flash_smem = {f"D{d},{dv} {dt}": smem(d, dv, int(dt == "bf16")) for d, dv in HEAD_DIMS
                  for dt in ("f32", "bf16")}
    bwd_smem = build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    bwd_smem.restype = ctypes.c_int
    flash_bwd_smem = {f"D{d},{dv} {dt} {k}": bwd_smem(d, dv, int(dt == "bf16"), i)
                      for d, dv in HEAD_DIMS for dt in ("f32", "bf16")
                      for i, k in enumerate(("dkdv", "dq"))}
    emit("build", seconds=time.perf_counter() - t0, report=report,
         flash_dynamic_smem_bytes=flash_smem, flash_bwd_dynamic_smem_bytes=flash_bwd_smem)


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
    cases = [("full", FLASH_FULL, torch.float32), ("full", FLASH_FULL, torch.bfloat16),
             ("granite", FLASH_GRANITE, torch.float32),
             ("granite", FLASH_GRANITE, torch.bfloat16), ("mla", FLASH_MLA, torch.float32),
             ("mla", FLASH_MLA, torch.bfloat16)]
    cases += [(label, shape, dt) for label, shape in (*WHISPER_FLASH.items(), *FLASH_TP.items(),
                                                      *FLASH_TP_FAMILIES.items())
              for dt in (torch.float32, torch.bfloat16)]
    if not full_only:
        cases += [(f"test{i}", shape, dt) for i, shape in enumerate(FLASH_SHAPES)
                  for dt in (torch.float32, torch.bfloat16)]
        cases += [("test_mla_ragged", FLASH_MLA_RAGGED, dt)
                  for dt in (torch.float32, torch.bfloat16)]
    worst = {}
    for label, (b, sq, sk, h, hk, d, causal), dt in cases:
        q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, dt, dev)
        heads_first = [t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]) for t in (q, k, v)]
        sk_valid = sk - 5 if label.startswith("test") else sk
        outs = [flash_attention_fwd(q, k, v, causal=causal),
                flash_attention_fwd(*heads_first, sk_valid=sk_valid, causal=causal)]
        torch.cuda.synchronize()
        bk = kernel_block_k(d, dt)  # the kernel's KV tile
        refs = [flash_attention_fwd_plain(q, k, v, causal=causal, block_k=bk),
                flash_attention_fwd_plain(*heads_first, sk_valid=sk_valid, causal=causal,
                                          block_k=bk)]
        errs, atols = {}, {}
        for name, o, r in zip(("bshd", "bhsd_tail"), outs, refs):
            check(o.dtype == dt and o.shape == r.shape, f"{label} {name}: {o.dtype} {o.shape}")
            atol = FLASH_TOL[dt]
            if dt == torch.bfloat16:
                atol = min(atol, FLASH_BF16_ATOL_OF_MAX * float(r.float().abs().max()))
            torch.testing.assert_close(o.float(), r.float(), atol=atol, rtol=FLASH_TOL[dt],
                                       msg=lambda m: f"{label} {name}: {m}")
            errs[name] = float((o.float() - r.float()).abs().max())
            atols[name] = atol
        dname = str(dt).replace("torch.", "")
        worst[dname] = max(worst.get(dname, 0.0), *errs.values())
        if label in ("granite", "mla", *WHISPER_FLASH, *FLASH_TP_FAMILIES):
            worst[f"{label}_{dname}"] = max(errs.values())
        emit("kernels", kernel="flash_attention_fwd", shape=label,
             b_sq_sk_h_hk_d_causal=[b, sq, sk, h, hk, d, causal], d_v=V_DIM[d], dtype=dname,
             sk_valid=sk_valid, atol=atols, rtol=FLASH_TOL[dt], max_abs_err=errs)
    return worst


def check_flash_bwd(dev, full_only):
    """The backward kernels against their plain version on the same inputs
    (q, k, v, the kernel forward's output and log-sum-exp, a cotangent), the
    plain version over the kernels' tile (``kernel_bwd_block``), at every
    training shape: f32 within 1e-5 (atol and rtol), bf16 within 2^-6 of
    each gradient's largest plain entry; two calls bit-equal. Not on the
    main path: these launches are not counted."""
    rng = np.random.default_rng(8)
    shapes = {"full": FLASH_FULL, "granite": FLASH_GRANITE, "mla_train": FLASH_MLA_TRAIN,
              "mla_ragged": FLASH_MLA_RAGGED, **WHISPER_FLASH, **FLASH_TP, **FLASH_TP_FAMILIES}
    if full_only:
        shapes = {k: shapes[k] for k in ("full", "mla_train")}
    worst = {}
    for label, (b, sq, sk, h, hk, d, causal) in shapes.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, dt, dev)
            do = normal(rng, (b, sq, h, v.shape[3]), dt, dev)
            o, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
            grads = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                             block_k=kernel_bwd_block(d))
            check(all(torch.equal(a, r) for a, r in zip(grads, again)),
                  f"flash backward {label} {dt}: two calls differ")
            errs, atols = {}, {}
            for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
                check(a.dtype == dt and a.shape == r.shape, f"{label} {name}: {a.dtype} {a.shape}")
                atol, rtol = TOL, TOL
                if dt == torch.bfloat16:
                    atol, rtol = FLASH_BF16_ATOL_OF_MAX * float(r.float().abs().max()), 0.0
                torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol,
                                           msg=lambda m: f"backward {label} {dt} {name}: {m}")
                errs[name] = float((a.float() - r.float()).abs().max())
                atols[name] = atol
            dname = str(dt).replace("torch.", "")
            worst[dname] = max(worst.get(dname, 0.0), *errs.values())
            emit("kernels", kernel="flash_attention_bwd", shape=label,
                 b_sq_sk_h_hk_d_causal=[b, sq, sk, h, hk, d, causal], d_v=V_DIM[d], dtype=dname,
                 atol=atols, rtol=TOL if dt == torch.float32 else 0.0, max_abs_err=errs,
                 repeat_bit_equal=True)
            del q, k, v, do, o, lse, grads, again, refs
    return worst


def check_ordered(dev, full_only):
    """The kernel against its plain version on the CPU (serial ``index_add_``,
    the reference's lane order) on the same lanes, bit for bit: both
    instruments' rows at 1, 128 and 1,024 lanes with duplicates and drops,
    every lane to one row, every lane dropped, and ORDERED_EDGES; ``dst``
    left as it was."""
    rng = np.random.default_rng(5)
    cases = [(name, rc, lanes, "mixed") for name, rc in ORDERED_ROWS.items()
             for lanes in (ORDERED_LANES[-1:] if full_only else ORDERED_LANES)]
    cases += [("obs_lat_comp", ORDERED_ROWS["obs_lat_comp"], ORDERED_LANES[-1], how)
              for how in ("one_row", "dropped")]
    if not full_only:
        cases += [("edge", (rows, cols), lanes, "mixed") for rows, cols, lanes in ORDERED_EDGES]
    for name, (rows, cols), lanes, how in cases:
        dst, idx, src = ordered_inputs(rng, rows, cols, lanes, dev, how)
        before = dst.clone()
        out = ordered_scatter_add(dst, idx, src)
        torch.cuda.synchronize()
        want = ordered_scatter_add_plain(dst.cpu(), idx.cpu(), src.cpu())
        check(torch.equal(out.cpu(), want), f"ordered_scatter_add {name} L={lanes} {how}: "
              f"{float((out.cpu() - want).abs().max())} from the CPU's lane order")
        check(torch.equal(dst, before), f"ordered_scatter_add {name}: dst was written")
        emit("kernels", kernel="ordered_scatter_add", rows=[rows, cols], lanes=lanes, idx=how,
             bit_equal_to_cpu=True)
    return 0.0


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


# --------------------------------------------------------------------------
# policy: the RARO KV-tier controller's behavioural cases on the card
# --------------------------------------------------------------------------
# tests/test_kvcache_policy.py's CacheConfig
POLICY_TEST = dict(n_seqs=2, max_pages=8, page_size=4, n_kv_heads=2, head_dim=8,
                   pool_pages=(8, 8, 64), migrate_per_step=4)
POLICY_CASES = ("cold_pages_stay_dense", "hot_pages_get_promoted",
                "disabled_controller_is_static_int4", "retry_estimate_grows_with_reads_and_density",
                "elastic_recovery_demotes_under_pressure", "capacity_accounting_matches_tiers")


def policy_case(name, ccfg, size):
    """One of tests/test_kvcache_policy.py's six cases at the cache config
    ``ccfg`` (``size`` "test" or "tinyllama"): (cache config, RARO config,
    tokens, masses (tokens, B, MaxP) f32 numpy, the test's assertion on the
    final cache). Token counts and the hot-then-cold schedule scale with the
    page size, so each case commits as many pages per sequence as the
    test's (4 tokens a page)."""
    k = ccfg.page_size // POLICY_TEST["page_size"]
    rcfg = tiers.RAROConfig()
    tokens = {"retry_estimate_grows_with_reads_and_density": 16,
              "elastic_recovery_demotes_under_pressure": 36}.get(name, 24) * k
    masses = np.zeros((tokens, ccfg.n_seqs, ccfg.max_pages), np.float32)

    def int4_only(c, cc, rc):
        t = c.tier.cpu().numpy()
        return bool((t[t >= 0] == modes.TIER_INT4).all())

    ok = int4_only  # cold_pages_stay_dense
    if name == "hot_pages_get_promoted":
        masses[:, :, 0] = 0.6

        def ok(c, cc, rc):
            t = c.tier.cpu().numpy()
            return bool((t[:, 0] == modes.TIER_BF16).all()
                        and (t[:, 2][t[:, 2] >= 0] == modes.TIER_INT4).all())
    elif name == "disabled_controller_is_static_int4":
        rcfg = tiers.RAROConfig(enabled=False)
        masses[:] = 0.4
    elif name == "retry_estimate_grows_with_reads_and_density":
        def ok(c, cc, rc):
            lo = tiers.page_retry_estimate(c, rc).cpu().numpy()
            hi = tiers.page_retry_estimate(c._replace(reads=c.reads + 50.0), rc).cpu().numpy()
            sel = c.tier.cpu().numpy() >= 0
            return bool((hi[sel] >= lo[sel]).all() and hi[sel].max() > 0)
    elif name == "elastic_recovery_demotes_under_pressure":
        # the test's pools at its size; the serve phase's at tinyllama's
        ccfg = replace(ccfg, high_watermark=0.4,
                       **({"pool_pages": (2, 4, 64)} if size == "test" else {}))
        rcfg = tiers.RAROConfig(heat=hotness.HeatConfig(decay=0.6, hot_thresh=0.08,
                                                        warm_thresh=0.02))
        masses[:12 * k, :, :2] = 0.6  # hot, then cold for the rest

        def ok(c, cc, rc):
            return float(1.0 - c.free[0].float().mean()) <= 0.5 + 1e-6
    elif name == "capacity_accounting_matches_tiers":
        def ok(c, cc, rc):
            p, hk, dh = cc.page_size, cc.n_kv_heads, cc.head_dim
            per = {0: 2 * p * hk * dh * 2, 1: 2 * p * hk * dh, 2: p * hk * dh}
            t = c.tier.cpu().numpy()
            return paged.memory_bytes(c, cc) == sum(per[int(x)] for x in t[t >= 0])
    return ccfg, rcfg, tokens, masses, ok


def policy_run(ccfg, rcfg, tokens, masses, dev, key=0):
    """The test's ``_fill`` on ``dev``: each step commit_tier, append and
    raro_step, K and V drawn by numpy from ``key`` (copied to the device
    once). Returns the final cache and the moves of every raro_step summed
    by kind."""
    rng = np.random.default_rng(key)
    shape = (tokens, ccfg.n_seqs, ccfg.n_kv_heads, ccfg.head_dim)
    ks = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    vs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    ms = torch.from_numpy(masses).to(dev)
    c = paged.init(ccfg, torch.float32, dev)
    moves = {}
    for t in range(tokens):
        c = paged.append(c, ccfg, ks[t], vs[t], tiers.commit_tier(c, ccfg, rcfg))
        c, stats = tiers.raro_step(c, ccfg, rcfg, ms[t])
        for kind, n in stats.items():
            moves[kind] = moves.get(kind, 0) + n
    return c, {kind: int(n) for kind, n in moves.items()}


def phase_policy(dev, cfg):
    """tests/test_kvcache_policy.py's six cases on the card through
    quant_store_pages, at the test's CacheConfig and at tinyllama-1.1b's
    serve widths (4 KV heads of 64, the serve phase's page size, pools and
    pages per sequence at batch 4). Each case runs on the card and on the
    CPU (the plain versions) from the same numpy draws: every TieredKV leaf
    (tier and slot tables, free masks, bf16 pages, int8/int4 codes and
    scales, heat, reads, counters), the moves and page_retry_estimate must
    be equal, and the test's assertion must hold on the card's state. The
    counts are set to 0 just before each card run and read just after: one
    store launch per append and, with RARO on, one per quantizing move of
    raro_step (three a step); no other kernel. Returns the launches."""
    sizes = {"test": paged.CacheConfig(**POLICY_TEST),
             "tinyllama": serve.cache_config(cfg, STEPS, 4)}
    total = Counter()
    t_phase = time.perf_counter()
    for size, base in sizes.items():
        for name in POLICY_CASES:
            ccfg, rcfg, tokens, masses, ok = policy_case(name, base, size)
            t0 = time.perf_counter()
            c_cpu, moves_cpu = policy_run(ccfg, rcfg, tokens, masses, "cpu")
            cpu_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            c, moves = policy_run(ccfg, rcfg, tokens, masses, dev)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            n = counts()
            want = {"tiered_decode_partial": 0, "flash_attention_fwd": 0,
                    "quantize_pages": tokens * (4 if rcfg.enabled else 1),
                    "ordered_scatter_add": 0, "flash_attention_bwd": 0}
            check(n == want, f"policy {size}/{name}: launches {n}, want {want}")
            total.update(n)
            for f in paged.TieredKV._fields:
                a, b = getattr(c_cpu, f), getattr(c, f)
                same = (all(torch.equal(x, y.cpu()) for x, y in zip(a, b)) if f == "free"
                        else torch.equal(a, b.cpu()))
                check(same, f"policy {size}/{name}: {f} differs between the card and the CPU")
            check(moves == moves_cpu, f"policy {size}/{name}: moves {moves} vs {moves_cpu}")
            est = tiers.page_retry_estimate(c, rcfg)
            check(torch.equal(est.cpu(), tiers.page_retry_estimate(c_cpu, rcfg)),
                  f"policy {size}/{name}: page_retry_estimate differs")
            check(ok(c, ccfg, rcfg), f"policy {size}/{name}: the test's assertion fails on the card")
            t = c.tier.cpu().numpy()
            emit("policy", size=size, case=name, n_seqs=ccfg.n_seqs, max_pages=ccfg.max_pages,
                 page_size=ccfg.page_size, n_kv_heads=ccfg.n_kv_heads, head_dim=ccfg.head_dim,
                 pool_pages=list(ccfg.pool_pages), tokens=tokens, raro=rcfg.enabled,
                 quant_store_pages_launches=n["quantize_pages"], moves=moves,
                 tier_pages=[int((t == i).sum()) for i in range(3)],
                 pool_occupancy=[float(1.0 - f.float().mean()) for f in c.free],
                 max_retry_estimate=int(est.max()), card_ms=card_ms, cpu_ms=cpu_ms,
                 card_ms_per_token=card_ms / tokens, equal_to_cpu=True)
    emit("policy", cases=2 * len(POLICY_CASES), launches=dict(total),
         seconds=time.perf_counter() - t_phase)
    return dict(total)


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
    """Within the block, every ``prefill`` and ``decode_step`` call of
    ``module`` (the family's model module, ``transformer`` unless given, which
    the registry's entries, and so make_prefill and make_serve_step, reach)
    appends its logits to ``self.logits``."""

    def __init__(self, module=transformer):
        self.module = module
        self.logits = []
        self.saved = {}

    def __enter__(self):
        for name in ("prefill", "decode_step"):
            fn = self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def recorded(*a, **kw):
            logits, cache = fn(*a, **kw)
            self.logits.append(logits)
            return logits, cache
        return recorded

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def pad_cache(cache, cfg, batch, seq):
    """A prefill cache (exactly as long as the prompt; the reference decodes at
    pos % S) lengthened to ``cfg``'s ``init_cache_specs(batch, seq)``: a leaf
    whose spec is longer on one axis grows there, by zeros or, where the spec
    initializes to ones (the scales), ones. This caller's choice lets the
    decode steps follow the prompt. A leaf as long as its spec (a recurrent
    state, whisper's cross-attention K and V) is kept."""
    specs = base.tree_paths(registry.get_api(cfg).init_cache_specs(batch, seq))

    def pad(path, t):
        spec = specs[path]
        grow = [i for i, (a, b) in enumerate(zip(t.shape, spec.shape)) if a != b]
        if not grow:
            return t
        ax = grow[0]
        check(t.dim() == len(spec.shape) and len(grow) == 1 and spec.shape[ax] > t.shape[ax],
              f"cache {path}: {tuple(t.shape)} does not grow to {spec.shape}")
        fill = t.new_ones if spec.init == "ones" else t.new_zeros
        return torch.cat([t, fill((*t.shape[:ax], spec.shape[ax] - t.shape[ax],
                                   *t.shape[ax + 1:]))], dim=ax)

    return base.tree_unflatten(cache, [pad(n, t) for n, t in base.tree_paths(cache).items()])


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
        cache_c = pad_cache(cache_c, cfg, batch, prompt + steps)
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
    serve_step.make_serve_step(cfg)(params, pad_cache(cache, cfg, batch, 129), tok[:, None],
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
            cache = pad_cache(cache, c, batch, prompt + steps)
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
                "quantize_pages": 0, "ordered_scatter_add": 0, "flash_attention_bwd": 0}
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
                    "flash_attention_fwd": 0, "ordered_scatter_add": 0,
                    "flash_attention_bwd": 0}
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


def phase_profile(dev, cfg, steps=2, batch=4):
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
    bytes_, flops = flash_cost(q, k, v, causal)
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
    # the training entry's launches in f32 (2-layer card-against-CPU steps):
    # the forward with its log-sum-exp, and the backward on the CUDA cores
    lse_ms, _ = time_launches(lambda: flash_attention_fwd_lse(q, k, v, causal=causal), n_iter=20)
    o, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
    do = normal(rng, o.shape, o.dtype, dev)
    bwd_ms, bwd_host_ms = time_launches(
        lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal), n_iter=5, warmup=2)
    bwd_bnd, bwd_by = bound_ms(*flash_bwd_cost(q, k, v, causal))  # CUDA cores' f32 rate
    emit("times", kernel="flash_attention_bwd", shape=list(FLASH_FULL), dtype="float32",
         ms=bwd_ms, host_ms=bwd_host_ms, bound_ms=bwd_bnd, bound_by=bwd_by,
         bound_rate="CUDA cores' f32, 67e12", forward_with_lse_ms=lse_ms)
    # the two launches of a chunk at Table III's 1,024 lanes, the lanes' rows
    # drawn evenly over the rows and the drop row
    rows = []
    for name, (r, c) in ORDERED_ROWS.items():
        dst, idx, src = ordered_inputs(rng, r, c, ORDERED_TIME_LANES, dev)
        ms, host_ms = time_launches(lambda: ordered_scatter_add(dst, idx, src))
        plain, plain_host_ms = time_launches(lambda: ordered_scatter_add_plain(dst, idx, src))
        ext = torch.cat([dst, dst.new_zeros((1, c))])
        # the yardstick, never called by the port: one index_add_ on CUDA (atomic adds,
        # in no fixed order), out of place into dst with its drop row
        lib_ms, lib_host_ms = time_launches(lambda: torch.index_add(ext, 0, idx, src))
        bytes_, flops = ordered_cost(dst, idx, src)
        bnd, by = bound_ms(bytes_, flops)
        rows.append(dict(ms=ms, plain_ms=plain, bytes=bytes_, flops=flops, library_ms=lib_ms))
        emit("times", kernel="ordered_scatter_add", rows=[r, c], lanes=ORDERED_TIME_LANES,
             ms=ms, host_ms=host_ms, plain_ms=plain, plain_host_ms=plain_host_ms, bytes=bytes_,
             flops=flops, bound_ms=bnd, bound_by=by, launch_floor_ms=floor_ms,
             library="torch.index_add (CUDA atomics, no fixed order)", library_ms=lib_ms,
             library_host_ms=lib_host_ms)
    out["ordered_scatter_add"] = dict(
        _mean_row([{k: v for k, v in r.items() if k != "library_ms"} for r in rows]),
        library_ms=sum(r["library_ms"] for r in rows) / len(rows))
    out["flash_granite"] = time_flash_bf16(rng, floor_ms, FLASH_GRANITE)
    out["flash_mla"] = time_flash_bf16(rng, floor_ms, FLASH_MLA)
    for label, shape in (*WHISPER_FLASH.items(), *FLASH_TP_FAMILIES.items()):
        out[f"flash_{label}"] = time_flash_bf16(rng, floor_ms, shape)
    return out


def time_flash_bf16(rng, floor_ms, shape):
    """One launch at a model's shape in bf16 (granite-moe-3b-a800m's prefill
    and training forward; deepseek-v3-671b's MLA prefill, whose v head is
    narrower; whisper-medium's encoder, decoder and cross-attention), its
    plain version and PyTorch's fused attention; and one call of the backward
    kernels at the same shape beside their bound."""
    b, sq, sk, h, hk, d, causal = shape
    q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, torch.bfloat16, "cuda")
    ms, host_ms = time_launches(lambda: flash_attention_fwd(q, k, v, causal=causal), n_iter=20)
    plain, _ = time_launches(lambda: flash_attention_fwd_plain(q, k, v, causal=causal),
                             n_iter=3, warmup=1)
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():  # the yardstick, never called by the port
        return torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                                enable_gqa=True)

    lib_ms, _ = time_launches(library, n_iter=20)
    lib_err = float((library().transpose(1, 2).float()
                     - flash_attention_fwd(q, k, v, causal=causal).float()).abs().max())
    bytes_, flops = flash_cost(q, k, v, causal)
    rate, rate_name = FLASH_RATE[q.dtype]
    bnd, by = bound_ms(bytes_, flops, rate)
    o, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
    do = normal(rng, o.shape, o.dtype, o.device)
    bwd_ms, _ = time_launches(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
                              n_iter=20)
    bwd_bnd, _ = bound_ms(*flash_bwd_cost(q, k, v, causal), rate)
    row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
               backward_ms=bwd_ms, backward_bound_ms=bwd_bnd)
    emit("times", kernel="flash_attention_fwd", shape=list(shape), d_v=V_DIM[d], dtype="bfloat16",
         host_ms=host_ms, bytes=bytes_, flops=flops, bound_rate=rate_name,
         launch_floor_ms=floor_ms, library="torch.nn.functional.scaled_dot_product_attention",
         library_max_abs_err=lib_err, **row)
    return row


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
TRAIN_STEPS = 8  # full-width steps of the train phase's main run
TRAIN_BATCH, TRAIN_SEQ = 4, PROMPT  # 8,192 tokens a step
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"  # git-ignored: (d)'s checkpoints
# (a): one step of a 2-layer model at tinyllama's widths in f32, card against CPU
TRAIN_CMP = dict(n_layers=2, batch=2, seq=256, lr=1e-3)
# Tolerances of (a). The card's attention is the flash kernel (3xTF32, within
# 1e-5 of the plain f32 attention) and its products cuBLAS's f32 GEMMs; the
# CPU's are the plain blockwise attention and the CPU's GEMMs: one function,
# summed in other orders. Loss and grad norm: rtol 1e-5. Moments, per leaf:
# atol 1e-4 of the leaf's largest |entry| plus rtol 1e-4. Parameters: AdamW's
# first step from zero moments moves an entry by lr * r(x) + lr * wd * p, where
# x = g * clip = m / (1 - b1) and r(x) = x / (|x| + eps): a function of each
# side's own m, whose slope eps / (|x| + eps)^2 is steep where the gradient
# cancels to ~eps (tests/test_torch_train.py measured steps 4% of lr apart
# there between the port and the JAX package). So each entry may differ by
# what the two sides' first moments imply, lr * |r(x_card) - r(x_cpu)|, plus
# 1e-2 lr for the update's own roundings; the moments are held above.
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-5, moments=1e-4, params_of_lr=1e-2)
# the flash kernels by name: the f32 route's attention kernel and its KV
# preparation, the bf16 route's one kernel
FLASH_KERNEL_NAMES = ("flash_attention_fwd_kernel", "flash_prepare_kv_kernel",
                      "flash_attention_bf16_kernel")
# the backward's three kernels: Delta, dK and dV, dQ
FLASH_BWD_KERNEL_NAMES = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def numpy_params(cfg, seed):
    """Parameters of ``cfg`` drawn by numpy in f32, by the specs' initializers
    (as ``base.materialize`` scales them)."""
    rng = np.random.default_rng(seed)

    def init(spec):
        if spec.init in ("zeros", "ones"):
            return torch.full(spec.shape, float(spec.init == "ones"))
        scale = 1.0
        if spec.init == "scaled" and len(spec.shape) >= 2:
            scale = 1.0 / math.sqrt(spec.shape[-2])
        elif spec.init == "normal":
            scale = 0.02
        return torch.from_numpy(rng.standard_normal(spec.shape, dtype=np.float32)
                                * np.float32(scale))

    return base.tree_map(init, registry.get_api(cfg).specs())


def step1_param_gap(m_card, m_cpu, ocfg):
    """Per entry: how far AdamW's first step moves a parameter apart on two
    sides with these first moments (m = (1 - b1) x, x the clipped gradient):
    lr * |r(x_card) - r(x_cpu)|, r(x) = x / (|x| + eps)."""
    def r(m):
        x = m.double() / (1 - ocfg.b1)
        return x / (x.abs() + ocfg.eps)

    return ocfg.lr * (r(m_card) - r(m_cpu)).abs()


def train_card_vs_cpu(dev, c, smi, batch=None, seed=7, phase="train", part="a_card_vs_cpu"):
    """(a) One make_train_step step of ``c`` in f32 (f32 parameters and
    dtype; TF32 off, as phase_device sets it), the same numpy-made parameters
    (from ``seed``) and batch (default: SyntheticLM's) on the card and on the
    CPU: loss, grad norm, and every updated moment and parameter (TRAIN_TOL).
    The errors are printed before they are checked; the flash launches of the
    card's step must be the forward's and remat's recompute's, and one
    backward an attention. Returns the launches."""
    check(c.dtype == torch.float32, f"{c.arch} is held in f32, not {c.dtype}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    ocfg = optim.AdamWConfig(lr=TRAIN_CMP["lr"], warmup=1, total_steps=10)
    p_cpu = numpy_params(c, seed)
    p_dev = base.tree_map(lambda t: t.to(dev, copy=True), p_cpu)  # the step works in place
    if batch is None:
        data = SyntheticLM(DataConfig(vocab=c.vocab, seq_len=TRAIN_CMP["seq"],
                                      global_batch=TRAIN_CMP["batch"], seed=1))
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    step = train_step.make_train_step(c, ocfg)
    reset_counts()
    p_dev, s_dev, m_dev = step(p_dev, optim.init(p_dev), {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    n = counts()
    p_cpu, s_cpu, m_cpu = step(p_cpu, optim.init(p_cpu), batch)
    errs, fails = {}, []
    for key in ("loss", "grad_norm"):
        a, r = float(m_dev[key]), float(m_cpu[key])
        errs[key] = abs(a - r) / abs(r) if math.isfinite(a) else math.inf
        if not errs[key] <= TRAIN_TOL[key]:
            fails.append(f"{key}: card {a}, CPU {r}")
    worst = dict.fromkeys(("m", "v", "params"), 0.0)
    used = dict.fromkeys(worst, 0.0)  # the largest share of its tolerance an entry takes
    wide = 0  # parameter entries the moments move apart by over lr / 10 (r is steep there)
    unexplained = 0.0  # the most a parameter differs beyond what its moments imply, over lr
    leaves = zip(*(base.tree_leaves(t) for t in (s_dev.m, s_cpu.m, s_dev.v, s_cpu.v, p_dev, p_cpu)))
    for md, mc, vd, vc, pd, pc in leaves:
        for name, a, r in (("m", md, mc), ("v", vd, vc), ("params", pd, pc)):
            d = (a.cpu().double() - r.double()).abs()
            if name == "params":
                gap = step1_param_gap(md.cpu(), mc, ocfg)
                tol = gap + TRAIN_TOL["params_of_lr"] * ocfg.lr
                wide += int((gap > 0.1 * ocfg.lr).sum())
                worst[name] = max(worst[name], float(d.max()) / ocfg.lr)
                unexplained = max(unexplained, float((d - gap).max()) / ocfg.lr)
            else:
                big = float(r.abs().max())
                tol = TRAIN_TOL["moments"] * (big + r.double().abs())
                worst[name] = max(worst[name], float(d.max()) / max(big, 1e-30))
            share = float((d / tol.clamp(min=1e-300)).max())
            used[name] = max(used[name], share)
            if share > 1:
                fails.append(f"{name}: {int((d > tol).sum())} entries outside the tolerance")
    errs.update(m_max_err_of_leaf_max=worst["m"], v_max_err_of_leaf_max=worst["v"],
                params_max_abs_err_over_lr=worst["params"], tolerance_used=used,
                params_moved_apart_over_lr_tenth=wide,
                params_max_err_beyond_moments_over_lr=unexplained)
    emit(phase, part=part, nvidia_smi=smi, arch=c.arch, n_layers=c.n_layers,
         n_enc_layers=c.n_enc_layers, d_model=c.d_model, dtype="float32", tf32=False,
         batch=int(batch["tokens"].shape[0]), seq=int(batch["tokens"].shape[1]), lr=ocfg.lr,
         loss=float(m_cpu["loss"]), grad_norm=float(m_cpu["grad_norm"]), tol=TRAIN_TOL,
         errors=errs, launches=n)
    # the forward's flash launches, and remat's recompute's in the backward
    want = flash_per_forward(c) * (2 if c.remat else 1)
    check(n["flash_attention_fwd"] == want and n["flash_attention_bwd"] == flash_per_forward(c),
          f"{c.arch} flash launches {n}, want {want} forward, {flash_per_forward(c)} backward")
    check(not fails, f"{c.arch} card against CPU: {fails}")
    return n


def flash_per_forward(cfg):
    """Flash launches of one forward (a training forward, or a prefill): one
    per attention layer of a windowless model without MTP (whisper: its
    encoder layers, and its decoder layers' self- and cross-attention); none
    for xlstm or the windowed zamba2."""
    check(not cfg.mtp_depth, f"{cfg.arch}: the MTP block's launches are not counted here")
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family in ("ssm", "hybrid") or cfg.window:
        return 0
    return cfg.n_layers


def exact_attention(q, k, v, *, causal):
    """``attn.reference_attention``'s function taken in float64 throughout
    (scores, softmax, products; no cast to f32), out in float64: the f32
    gradient checks' reference. An f32 sum over a head group's 16,384
    queries (tinyllama's training shape) strays ~1e-4 from the exact value
    in any order, so f32 blockwise attention's own autograd lies up to
    8.6e-5 from this there (on an H100), beyond FLASH_TOL."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    qg = attn._gqa_split(q.double(), hk) * d**-0.5
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.double())
    if causal:
        later = torch.ones(sq, sk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(later[None, :, None, None, :], -torch.inf)
    out = torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, dim=-1), v.double())
    return out.reshape(b, sq, h, v.shape[-1])


def autograd_entry_check(dev, smi, shape, phase, part, seed):
    """The autograd entry (the flash kernel forward with its log-sum-exp, the
    backward kernels) against the plain attention's own autograd at
    ``shape``: in f32 against ``exact_attention`` (f64), in bf16 against the
    plain blockwise attention (f32 inside, bf16 out); output and dq, dk, dv
    within FLASH_TOL. f32 blockwise's own distance from the exact gradient is
    printed beside. flash_attention_fwd must refuse inputs that require grad.
    Returns the errors by dtype name and the last (bf16) q, k, v and output
    gradient."""
    rng = np.random.default_rng(seed)
    b, sq, sk, h, hk, d, causal = shape
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(rng, b, sq, sk, h, hk, d, dt, dev)
        do = normal(rng, (*q.shape[:3], v.shape[3]), dt, dev)

        def grads(f, *ins):
            leaves = [t.clone().requires_grad_() for t in ins]
            o = f(*leaves)
            return [o.detach(), *torch.autograd.grad(o, leaves, do.to(o.dtype))]

        got = grads(lambda *a: flash_attention_train(*a, causal=causal), q, k, v)
        blockwise = grads(lambda *a: attn.blockwise_attention(*a, causal=causal), q, k, v)
        if dt == torch.float32:
            ref = grads(lambda *a: exact_attention(*a, causal=causal),
                        *(t.double() for t in (q, k, v)))
            blockwise_errs = {name: float((a.double() - r).abs().max())
                              for name, a, r in zip(("o", "dq", "dk", "dv"), blockwise, ref)}
        else:
            ref, blockwise_errs = blockwise, None
        errs = {}
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
            check(a.dtype == dt and a.shape == r.shape, f"{name}: {a.dtype} {a.shape}")
            torch.testing.assert_close(a.double(), r.double(), atol=FLASH_TOL[dt],
                                       rtol=FLASH_TOL[dt], msg=lambda m: f"{dt} {name}: {m}")
            errs[name] = float((a.double() - r.double()).abs().max())
        del got, blockwise, ref
        q.requires_grad_()
        try:
            flash_attention_fwd(q, k, v, causal=causal)
            refused = False
        except RuntimeError as e:
            refused = "flash_attention_train" in str(e)
        q.requires_grad_(False)
        check(refused, "flash_attention_fwd ran on inputs that require grad")
        dname = str(dt).replace("torch.", "")
        out[dname] = dict(max_abs_err=errs)
        emit(phase, part=part, nvidia_smi=smi, b_sq_sk_h_hk_d_causal=list(shape), d_v=V_DIM[d],
             dtype=dname, tol=FLASH_TOL[dt],
             reference="exact_attention (f64)" if blockwise_errs else "blockwise_attention",
             max_abs_err=errs, blockwise_f32_max_abs_err_from_exact=blockwise_errs,
             fwd_refuses_grad=refused)
        torch.cuda.empty_cache()
    return out, (q, k, v, do)


def train_attention_check(dev, smi):
    """(b) The autograd entry against the plain attention's autograd at the
    training shape (``autograd_entry_check``). Then, in bf16, the times of
    the forward kernel, the forward with its log-sum-exp (the training
    entry's), the backward kernels (one call: Delta, dK and dV, dQ) beside
    their bound, the plain backward, the entry's whole backward through
    autograd, and PyTorch's fused attention, forward and backward."""
    causal = FLASH_FULL[-1]
    out, (q, k, v, do) = autograd_entry_check(dev, smi, FLASH_FULL, "train", "b_autograd_entry", 6)
    # times at the training shape in bf16 (q, k, v, do of the last pass)
    ms, host_ms = time_launches(lambda: flash_attention_fwd(q, k, v, causal=causal), n_iter=20)
    lse_ms, _ = time_launches(lambda: flash_attention_fwd_lse(q, k, v, causal=causal), n_iter=20)
    plain, _ = time_launches(lambda: flash_attention_fwd_plain(q, k, v, causal=causal),
                             n_iter=5, warmup=2)
    o, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
    bwd_kernel_ms, bwd_host_ms = time_launches(
        lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal), n_iter=20)
    bwd_plain_ms, _ = time_launches(
        lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal), n_iter=3, warmup=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_train(*leaves, causal=causal)
    bwd_ms, _ = time_launches(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              n_iter=10, warmup=2)
    del o, leaves
    # the yardstick, never called by the port: PyTorch's fused attention, (B, H, S, D)
    lleaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(*lleaves, is_causal=causal,
                                                                enable_gqa=True)

    with torch.no_grad():
        lib_ms, _ = time_launches(library, n_iter=20)
    ol, dol = library(), do.transpose(1, 2).contiguous()
    lib_bwd_ms, _ = time_launches(lambda: torch.autograd.grad(ol, lleaves, dol, retain_graph=True),
                                  n_iter=10, warmup=2)
    del ol, lleaves
    bytes_, flops = flash_cost(q, k, v, causal)
    rate, rate_name = FLASH_RATE[q.dtype]
    bnd, by = bound_ms(bytes_, flops, rate)
    bwd_bnd, bwd_by = bound_ms(*flash_bwd_cost(q, k, v, causal), rate)
    out["times"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                        lse_ms=lse_ms, backward_ms=bwd_ms, library_backward_ms=lib_bwd_ms)
    out["bwd_times"] = dict(ms=bwd_kernel_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bnd,
                            bound_by=bwd_by, library_ms=lib_bwd_ms, host_ms=bwd_host_ms,
                            entry_backward_ms=bwd_ms)
    emit("train", part="b_times", nvidia_smi=smi, kernel="flash_attention_fwd",
         b_sq_sk_h_hk_d_causal=list(FLASH_FULL), dtype="bfloat16", host_ms=host_ms,
         bound_rate=rate_name, library="torch.nn.functional.scaled_dot_product_attention",
         **out["times"])
    emit("train", part="b_times", nvidia_smi=smi, kernel="flash_attention_bwd",
         b_sq_sk_h_hk_d_causal=list(FLASH_FULL), dtype="bfloat16", bound_rate=rate_name,
         library="the backward of torch.nn.functional.scaled_dot_product_attention",
         **out["bwd_times"])
    return out


@contextlib.contextmanager
def recorded_steps(records):
    """While active, each step of a ``train_step.make_train_step`` step
    function (``launch.train.run`` builds one) is timed between two
    synchronizes, and its ms, flash forward and backward launches, loss and
    grad norm are appended to ``records``. Yields the unwrapped
    ``make_train_step``."""
    make = train_step.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            n0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            torch.cuda.synchronize()
            records.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                flash_launches=flash_attention_fwd.launches - n0,
                                flash_bwd_launches=flash_attention_bwd.launches - b0,
                                loss=float(metrics["loss"]),
                                grad_norm=float(metrics["grad_norm"])))
            return params, opt_state, metrics

        return timed

    train_step.make_train_step = recording
    try:
        yield make
    finally:
        train_step.make_train_step = make


def train_run(dev, cfg, smi, phase="train"):
    """(c) The main path: launch.train.run at full width and depth. Each step
    is timed between two synchronizes and its flash launches counted; the
    counts are set to 0 just before the run and read just after it. Then one
    profiled step. Lines go out under ``phase``; the backward's launches are
    noted in BWD_BY_PATH under it."""
    records = []
    with recorded_steps(records) as make:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        params, hist = train.run(cfg.arch, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ, log_every=1, device=dev)
        torch.cuda.synchronize()
        n = counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.n_layers  # the forward, and remat's recompute in the backward
    bwd_per_step = cfg.n_layers
    check(len(records) == TRAIN_STEPS and [l for _, l in hist] == [r["loss"] for r in records],
          f"{len(records)} steps recorded, hist {hist}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records),
          f"non-finite loss or grad norm: {records}")
    check(all(r["flash_launches"] == per_step and r["flash_bwd_launches"] == bwd_per_step
              for r in records)
          and n == {"flash_attention_fwd": per_step * TRAIN_STEPS, "tiered_decode_partial": 0,
                    "quantize_pages": 0, "ordered_scatter_add": 0,
                    "flash_attention_bwd": bwd_per_step * TRAIN_STEPS},
          f"flash launches per step (forward, backward) "
          f"{[(r['flash_launches'], r['flash_bwd_launches']) for r in records]}, total {n}")
    BWD_BY_PATH[phase] = n["flash_attention_bwd"]
    specs = registry.get_api(cfg).specs()
    check(all(t.dtype == sp.dtype for t, sp in zip(base.tree_leaves(params),
                                                   base.tree_leaves(specs))),
          "params are not in their specs' dtypes")
    for i, r in enumerate(records):
        emit(phase, part="c_step", nvidia_smi=smi, step=i, **r)
    ms = sum(r["ms"] for r in records[1:]) / (len(records) - 1)
    summary = dict(arch=cfg.arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
                   params=base.n_params(specs), dtype=str(cfg.dtype).replace("torch.", ""),
                   remat=cfg.remat, xent_chunk=cfg.xent_chunk, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   steps=TRAIN_STEPS, first_step_ms=records[0]["ms"], ms_per_step_after_first=ms,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
                   max_memory_allocated=peak, launches=n, flash_launches_per_step=per_step,
                   flash_bwd_launches_per_step=bwd_per_step)

    # where one step's device time goes, after the run, from its final parameters
    ocfg = optim.AdamWConfig(lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
    step = make(cfg, ocfg)
    opt = optim.init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
    step(params, opt, b)
    torch.cuda.synchronize()
    wall_ms, device_ms, cpu_ms = profiled(lambda: step(params, opt, b))
    busy = sum(device_ms.values())
    flash_ms = sum(v for k, v in device_ms.items() if any(f in k for f in FLASH_KERNEL_NAMES))
    bwd_ms = sum(v for k, v in device_ms.items() if any(f in k for f in FLASH_BWD_KERNEL_NAMES))
    summary.update(profiled_wall_ms=wall_ms, device_busy_ms=busy or None,
                   device_busy_share=busy / wall_ms if busy else None,
                   flash_kernel_ms=flash_ms if busy else None,
                   flash_share_of_busy=flash_ms / busy if busy else None,
                   flash_bwd_kernel_ms=bwd_ms if busy else None,
                   flash_bwd_share_of_busy=bwd_ms / busy if busy else None,
                   top_device_ms=top(device_ms, 1, 10), top_host_inclusive_ms=top(cpu_ms, 1, 8))
    emit(phase, part="c_full_width", nvidia_smi=smi, **summary)
    return n


def train_resume(dev, cfg, smi):
    """(d) A 2-layer run of 6 steps, and the same run cut at step 3 and
    resumed from its checkpoint: the losses must be equal bit for bit."""
    kw = dict(smoke=False, batch=2, seq=256, log_every=1, device=dev,
              cfg=cfg.with_(n_layers=2))
    _, straight = train.run(cfg.arch, steps=6, **kw)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        _, first = train.run(cfg.arch, steps=3, ckpt_dir=str(TRAIN_DIR), **kw)
        _, second = train.run(cfg.arch, steps=6, ckpt_dir=str(TRAIN_DIR), **kw)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    check(second[0][0] == 3, f"the second run started at step {second[0][0]}, not 3")
    check(first + second == straight, f"resumed {first + second} != straight {straight}")
    emit("train", part="d_resume", nvidia_smi=smi, n_layers=2, dtype="bfloat16", batch=2,
         seq=256, losses=[l for _, l in straight], resumed_at=3, bit_equal=True)


def phase_train(dev, cfg, smi):
    """Training on the card (see the module docstring, phase 9). Returns the
    main run's launch counts and the flash kernel's training-shape numbers."""
    train_card_vs_cpu(dev, cfg.with_(n_layers=TRAIN_CMP["n_layers"], dtype=torch.float32), smi)
    attention = train_attention_check(dev, smi)
    launches = train_run(dev, cfg, smi)
    train_resume(dev, cfg, smi)
    return launches, attention


# --------------------------------------------------------------------------
# the MoE family: granite-moe-3b-a800m
# --------------------------------------------------------------------------
MOE_STEPS = 32  # decode steps of (b)
# (a): 2 layers at granite's widths in f32, card against CPU: a prefill of
# 4 x 64 tokens and 8 greedy steps, then one loss and gradient of 2 x 256
MOE_CMP = dict(cut=dict(n_layers=2), batch=4, prompt=64, steps=8, train_batch=2, train_seq=256,
               grad=True, seed=11)
# the mla phase's (a): deepseek-v3-671b at its published widths cut to 2 layers
# (1 dense, 1 MoE) and 16 routed experts (top-8 and the shared expert kept),
# ~3.1 B parameters, 12.5 GB in f32 on each side: a prefill of 2 x 64 tokens
# and 8 greedy steps, then one loss forward of 2 x 64 (MTP included)
MLA_CMP = dict(cut=dict(n_layers=2, first_k_dense=1, n_experts=16), batch=2, prompt=64, steps=8,
               train_batch=2, train_seq=64, grad=False, seed=13)
# the mla phase's (b): deepseek-v3's 3 dense layers and 1 MoE layer of all 256
# experts at the published widths, 14.87 B parameters, bf16 (the router f32)
MLA_SERVE_LAYERS = dict(n_layers=4, first_k_dense=3)
# Tolerances of (a). Logits and the prefill's cache: LOGITS_TOL, absolute, as
# the dense family's card-vs-CPU steps. Loss and grad norm: TRAIN_TOL's 1e-5
# relative. Routing is discrete: where two experts' router probabilities lie
# within the frameworks' f32 rounding of each other, the card may rightly
# pick the other, which moves that token's output by O(1); the run reports
# the smallest top-k margin it met, so a failure of that kind shows as such.


class RouterMargins:
    """Within the block, each ``ops.top_k`` call (the MoE router's) records the
    smallest gap between the k-th and the (k+1)-th largest value of a row:
    how near the run came to a routing tie."""

    def __init__(self):
        self.margins = []

    def __enter__(self):
        self.saved = port_ops.top_k

        def recorded(x, k):
            v, i = self.saved(x, k + 1) if k < x.shape[-1] else self.saved(x, k)
            if v.shape[-1] > k:
                self.margins.append((v[..., k - 1] - v[..., k]).min())
            return v[..., :k], i[..., :k]

        port_ops.top_k = recorded
        return self

    def __exit__(self, *exc):
        port_ops.top_k = self.saved

    def smallest(self):
        return min(float(m) for m in self.margins) if self.margins else None


def moe_card_vs_cpu(dev, cfg, smi, k=MOE_CMP, phase="moe"):
    """(a) make_prefill and k["steps"] make_serve_step steps of ``cfg`` cut by
    k["cut"] at its widths in f32, on the card and on the CPU from the same
    state each step: logits and the prefill's cache within LOGITS_TOL, the
    greedy tokens equal (but in rows whose two best logits on the CPU lie
    within it); then one loss, with its gradient where k["grad"], from the
    same parameters and batch: loss (and global grad norm) within TRAIN_TOL."""
    c = cfg.with_(**k["cut"], dtype=torch.float32)
    p_cpu = numpy_params(c, k["seed"])
    p_dev = base.tree_map(lambda t: t.to(dev), p_cpu)
    tokens = torch.tensor(np.random.default_rng(k["seed"] + 1).integers(
        0, c.vocab, (k["batch"], k["prompt"])).astype(np.int32))
    prefill, step = serve_step.make_prefill(c), serve_step.make_serve_step(c)
    worst, near_ties = {}, 0
    with RecordLogits(moe) as rec, RouterMargins() as rm:
        tok_c, cache_c = prefill(p_cpu, {"tokens": tokens})
        reset_counts()
        tok_d, cache_d = prefill(p_dev, {"tokens": tokens.to(dev)})
        torch.cuda.synchronize()
        n_prefill = counts()
        for name in cache_c:
            d = float((cache_d[name].cpu() - cache_c[name]).abs().max())
            check(d <= LOGITS_TOL, f"prefill cache {name}: {d} (smallest router margin "
                                   f"{rm.smallest()})")
            worst[f"cache_{name}"] = d
        cache_c = pad_cache(cache_c, c, k["batch"], k["prompt"] + k["steps"])
        worst_logits = 0.0
        for t in range(k["steps"] + 1):
            lg_c, lg_d = rec.logits[-2], rec.logits[-1].cpu()
            d = float((lg_d - lg_c).abs().max())
            check(d <= LOGITS_TOL, f"logits at step {t}: {d} (smallest router margin "
                                   f"{rm.smallest()})")
            worst_logits = max(worst_logits, d)
            ok, ties = same_tokens(tok_d, tok_c, lg_c)
            check(ok, f"greedy tokens differ at step {t}")
            near_ties += ties
            if t == k["steps"]:
                break
            pos = torch.full((k["batch"],), k["prompt"] + t, dtype=torch.int32)
            nxt_c, next_cache = step(p_cpu, cache_c, tok_c[:, None], pos)
            tok_d, _ = step(p_dev, {n: v.to(dev) for n, v in cache_c.items()},
                            tok_c[:, None].to(dev), pos.to(dev))
            tok_c, cache_c = nxt_c, next_cache
        worst["logits"] = worst_logits
        margin = rm.smallest()
    check(n_prefill["flash_attention_fwd"] == c.n_layers, f"prefill launches {n_prefill}")

    data = SyntheticLM(DataConfig(vocab=c.vocab, seq_len=k["train_seq"],
                                  global_batch=k["train_batch"], seed=1))
    batch = {n: torch.from_numpy(v) for n, v in data.batch_at(0).items()}
    loss_fn = registry.get_api(c).loss_fn
    batch_d = {n: v.to(dev) for n, v in batch.items()}
    reset_counts()
    if k["grad"]:
        l_d, g_d = train_step.value_and_grad(loss_fn, p_dev, batch_d)
        gn_d = optim.global_norm(g_d)
    else:
        with torch.no_grad():
            l_d = loss_fn(p_dev, batch_d)
    torch.cuda.synchronize()
    n_train = counts()
    errs, metrics = {}, {}
    if k["grad"]:
        l_c, g_c = train_step.value_and_grad(loss_fn, p_cpu, batch)
        gn_c = optim.global_norm(g_c)
        errs["grad_norm"] = abs(float(gn_d) - float(gn_c)) / abs(float(gn_c))
        metrics["grad_norm"] = float(gn_c)
    else:
        with torch.no_grad():
            l_c = loss_fn(p_cpu, batch)
    errs["loss"] = abs(float(l_d) - float(l_c)) / abs(float(l_c))
    emit(phase, part="a_card_vs_cpu", nvidia_smi=smi, arch=cfg.arch, cut=k["cut"],
         n_layers=c.n_layers, d_model=c.d_model, params=base.n_params(registry.get_api(c).specs()),
         dtype="float32", tf32=False, batch=k["batch"], prompt=k["prompt"],
         steps=k["steps"], max_abs_err=worst, near_ties=near_ties, tol=LOGITS_TOL,
         smallest_router_margin=margin, train_batch=k["train_batch"], train_seq=k["train_seq"],
         loss=float(l_c), **metrics, rel_err=errs,
         train_tol={key: TRAIN_TOL[key] for key in errs}, launches_prefill=n_prefill,
         **{"launches_loss_and_grad" if k["grad"] else "launches_loss": n_train})
    for key, e in errs.items():
        check(e <= TRAIN_TOL[key], f"{key}: card against CPU {e}")
    # each attention's forward (the MTP block's too), and with a gradient remat's
    # recompute in the backward
    want = (2 if k["grad"] else 1) * (c.n_layers + c.mtp_depth)
    want_bwd = (c.n_layers + c.mtp_depth) if k["grad"] else 0  # one backward an attention
    check(n_train["flash_attention_fwd"] == want and n_train["flash_attention_bwd"] == want_bwd,
          f"loss launches {n_train}, want {want} forward, {want_bwd} backward")


def timed_serve(mod, cfg, params, prefill, step, data, prompt, steps):
    """One counted serving run: the counts set to 0 and the peak memory reset
    just before ``prefill(params, data)``, then ``steps`` greedy steps from
    the padded cache. Returns the last tokens and cache, the prefill's and
    the steps' seconds, the counts after the prefill and after the steps,
    the peak memory, and every logits tensor (``mod``'s, by RecordLogits)."""
    batch = data["tokens"].shape[0]
    dev = data["tokens"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with RecordLogits(mod) as rec:
        t0 = time.perf_counter()
        tok, cache = prefill(params, data)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        n_prefill = counts()
        cache = pad_cache(cache, cfg, batch, prompt + steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            pos = torch.full((batch,), prompt + t, dtype=torch.int32, device=dev)
            tok, cache = step(params, cache, tok[:, None], pos)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return dict(tok=tok, cache=cache, prefill_s=prefill_s, decode_s=decode_s,
                n_prefill=n_prefill, n=counts(), peak=torch.cuda.max_memory_allocated(),
                logits=rec.logits)


def moe_serve(dev, cfg, smi, batch=4, prompt=PROMPT, steps=MOE_STEPS, phase="moe"):
    """(b) make_prefill over ``batch`` random prompts at ``cfg``'s widths and
    depth in bf16 (the specs' dtypes: bf16, the router f32), then ``steps``
    make_serve_step steps from the padded cache. The counts are set to 0 just
    before the run and read just after the prefill and after the steps: one
    flash launch per layer in the prefill, none in a decode step. Then the
    host syncs of one decode step, and (d) one profiled decode step. The peak
    memory of drawing the parameters (each tensor drawn in f32, then cast) is
    reported apart from serving's."""
    api = registry.get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0), device=dev)
    init_peak = torch.cuda.max_memory_allocated()
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prefill, step = serve_step.make_prefill(cfg), serve_step.make_serve_step(cfg)
    # warm-up (cuBLAS handles, the kernel's first load), outside the counted run
    tok, cache = prefill(params, {"tokens": tokens[:, :128]})
    step(params, pad_cache(cache, cfg, batch, 129), tok[:, None],
         torch.full((batch,), 128, dtype=torch.int32, device=dev))
    del cache
    r = timed_serve(moe, cfg, params, prefill, step, {"tokens": tokens}, prompt, steps)
    tok, cache, prefill_s, decode_s = r["tok"], r["cache"], r["prefill_s"], r["decode_s"]
    n_prefill, n, peak = r["n_prefill"], r["n"], r["peak"]
    want = {"flash_attention_fwd": cfg.n_layers, "tiered_decode_partial": 0, "quantize_pages": 0,
            "ordered_scatter_add": 0, "flash_attention_bwd": 0}
    check(n_prefill == want and n == want,
          f"launches {n_prefill} in the prefill and {n} in the run, want {want}")
    check(len(r["logits"]) == steps + 1
          and bool(torch.stack([torch.isfinite(x).all() for x in r["logits"]]).all()),
          "non-finite logits")
    shapes = {n: sp.shape for n, sp in api.init_cache_specs(batch, prompt + steps).items()}
    check({n: tuple(c.shape) for n, c in cache.items()} == shapes
          and all(c.dtype == torch.bfloat16 for c in cache.values()),
          f"cache {[(n, c.shape, c.dtype) for n, c in cache.items()]}, want {shapes}")
    pos = torch.full((batch,), prompt + steps, dtype=torch.int32, device=dev)
    (_, _), syncs = host_syncs(lambda: step(params, cache, tok[:, None], pos))
    emit(phase, part="b_serve", nvidia_smi=smi, arch=cfg.arch, n_layers=cfg.n_layers,
         first_k_dense=cfg.first_k_dense, d_model=cfg.d_model, n_experts=cfg.n_experts,
         top_k=cfg.top_k, dtype="bfloat16", params=base.n_params(api.specs()), batch=batch,
         prompt=prompt, steps=steps, cache={n: list(v) for n, v in shapes.items()},
         prefill_ms=prefill_s * 1e3, prompt_tokens_per_s=batch * prompt / prefill_s,
         decode_ms_per_step=decode_s * 1e3 / steps, decode_tokens_per_s=batch * steps / decode_s,
         init_max_memory_allocated=init_peak, max_memory_allocated=peak,
         launches_prefill=n_prefill, launches=n,
         flash_launches_per_decode_step=(n["flash_attention_fwd"]
                                         - n_prefill["flash_attention_fwd"]) / steps,
         host_syncs_per_decode_step=len(syncs), host_syncs_by_line=dict(Counter(syncs)))
    # (d) one profiled decode step
    wall_ms, device_ms, cpu_ms = profiled(lambda: step(params, cache, tok[:, None], pos))
    busy = sum(device_ms.values())
    emit(phase, part="d_profile_decode", nvidia_smi=smi, arch=cfg.arch, batch=batch,
         cache_len=prompt + steps, wall_ms=wall_ms, device_busy_ms=busy or None,
         device_busy_share=busy / wall_ms if busy else None,
         top_device_ms=top(device_ms, 1, 10), top_host_inclusive_ms=top(cpu_ms, 1, 8))
    return n["flash_attention_fwd"]


def phase_moe(dev, smi):
    """The MoE family on the card (see the module docstring, phase 10).
    Returns the flash launches of (b)'s serving run and (c)'s training run."""
    cfg = granite_moe_3b_a800m.CONFIG
    moe_card_vs_cpu(dev, cfg, smi)
    serve_launches = moe_serve(dev, cfg, smi)
    torch.cuda.empty_cache()
    train_launches = train_run(dev, cfg, smi, phase="moe")["flash_attention_fwd"]
    torch.cuda.empty_cache()
    return {"moe_prefill": serve_launches, "moe_train": train_launches}


def phase_mla(dev, smi):
    """deepseek-v3-671b's MLA on the card (see the module docstring, phase
    13): (a) card against CPU in f32, (b) the main serving path in bf16, (c)
    the autograd entry at MLA's head pair. Returns (b)'s flash launches and
    (c)'s errors."""
    cfg = deepseek_v3_671b.CONFIG
    moe_card_vs_cpu(dev, cfg, smi, MLA_CMP, phase="mla")
    torch.cuda.empty_cache()
    serve_launches = moe_serve(dev, cfg.with_(**MLA_SERVE_LAYERS), smi, phase="mla")
    torch.cuda.empty_cache()
    entry, _ = autograd_entry_check(dev, smi, FLASH_MLA_TRAIN, "mla", "c_autograd_entry", 14)
    torch.cuda.empty_cache()
    return serve_launches, entry


# --------------------------------------------------------------------------
# the last three families: whisper-medium, xlstm-125m, zamba2-2.7b
# --------------------------------------------------------------------------
# arch -> (config, model module, (a)'s depth cut, (b)'s prompt length). (a)'s
# cuts: whisper 2 encoder and 2 decoder layers; xlstm 4 layers (layer 3 is an
# sLSTM); zamba2 10 layers (one shared-attention application after layer 9,
# then a tail layer without). (b): whisper's 416-token prompt and 32 steps are
# 448 positions, its published decoder context
# (b)'s prompt of the recurrent families: a host-issued step per token, so
# their prefill's time is linear in it (~4 ms a token at batch 4); 1,024 of
# the published 2,048 halve it and leave the per-token cost as measured
FAM_RECURRENT_PROMPT = 1024
FAMILIES = {
    "whisper-medium": (whisper_medium.CONFIG, encdec, dict(n_layers=2, n_enc_layers=2), 416),
    "xlstm-125m": (xlstm_125m.CONFIG, xlstm, dict(n_layers=4), FAM_RECURRENT_PROMPT),
    "zamba2-2.7b": (zamba2_2_7b.CONFIG, hybrid, dict(n_layers=10), FAM_RECURRENT_PROMPT),
}
FAM_CMP = dict(batch=2, prompt=64, steps=8)  # (a)
FAM_BATCH, FAM_STEPS = 4, 32  # (b)
# (b)'s profiled prefill of xlstm and zamba2: per-token host loops, every
# token the same step, so 64 tokens show it (256 until PR 27: the profiler
# took 35-50 s of it on a slow host, near the script's 1,200 s)
FAM_PROFILE_PROMPT = 64
# (d)'s training batch: 2 x 32 tokens (at 64, zamba2's step on the CPU, a
# host step per token and layer, took 51-81 s of the script)
FAM_TRAIN_PROMPT = 32


def family_batch(cfg, rng, batch, prompt, labels=False):
    """Tokens (and labels) drawn by numpy, and for whisper the encoder's
    frames (B, enc_len, d_model), f32 as the stub frontend hands them over."""
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32))}
    if labels:
        out["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                                         .astype(np.int32))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal((batch, cfg.enc_len, cfg.d_model),
                                                             dtype=np.float32))
    return out


def tree_errs(a, b):
    """{path: max |a - b|} over the leaves of two caches of one structure
    (nested recurrent states too)."""
    fa = base.tree_paths(a)
    return {k: float((fa[k].cpu().float() - v.float()).abs().max())
            for k, v in base.tree_paths(b).items()}


def families_card_vs_cpu(dev, smi, arch, seed):
    """(a) make_prefill and FAM_CMP["steps"] make_serve_step steps of ``arch``
    cut by its FAMILIES depth at its widths in f32, on the card and on the CPU
    from the same state each step: logits and every leaf of the prefill's and
    each step's cache within LOGITS_TOL, the greedy tokens equal (but in rows
    whose two best logits on the CPU lie within it); then one loss_fn forward
    from the same parameters and batch, within TRAIN_TOL's 1e-5 relative."""
    cfg, mod, cut, _ = FAMILIES[arch]
    c = cfg.with_(**cut, dtype=torch.float32)
    k = FAM_CMP
    p_cpu = numpy_params(c, seed)
    p_dev = base.tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(seed)
    batch = family_batch(c, rng, k["batch"], k["prompt"])
    prefill, step = serve_step.make_prefill(c), serve_step.make_serve_step(c)
    worst, near_ties = {}, 0

    def held(errs, when):
        for name, e in errs.items():
            check(e <= LOGITS_TOL, f"{arch} {when} cache {name}: {e}")
            worst[name] = max(worst.get(name, 0.0), e)

    with RecordLogits(mod) as rec:
        tok_c, cache_c = prefill(p_cpu, batch)
        reset_counts()
        tok_d, cache_d = prefill(p_dev, {n: v.to(dev) for n, v in batch.items()})
        torch.cuda.synchronize()
        n_prefill = counts()
        held(tree_errs(cache_d, cache_c), "prefill")
        cache_c = pad_cache(cache_c, c, k["batch"], k["prompt"] + k["steps"])
        worst_logits = 0.0
        for t in range(k["steps"] + 1):
            lg_c, lg_d = rec.logits[-2], rec.logits[-1].cpu()
            d = float((lg_d - lg_c).abs().max())
            check(d <= LOGITS_TOL, f"{arch} logits at step {t}: {d}")
            worst_logits = max(worst_logits, d)
            ok, ties = same_tokens(tok_d, tok_c, lg_c)
            check(ok, f"{arch} greedy tokens differ at step {t}")
            near_ties += ties
            if t == k["steps"]:
                break
            pos = torch.full((k["batch"],), k["prompt"] + t, dtype=torch.int32)
            nxt_c, next_c = step(p_cpu, cache_c, tok_c[:, None], pos)
            tok_d, next_d = step(p_dev, base.tree_map(lambda v: v.to(dev), cache_c),
                                 tok_c[:, None].to(dev), pos.to(dev))
            held(tree_errs(next_d, next_c), f"step {t}")
            tok_c, cache_c = nxt_c, next_c
    n_steps = counts()

    train = family_batch(c, rng, k["batch"], k["prompt"], labels=True)
    loss_fn = registry.get_api(c).loss_fn
    reset_counts()
    with torch.no_grad():
        l_d = loss_fn(p_dev, {n: v.to(dev) for n, v in train.items()})
        torch.cuda.synchronize()
        n_loss = counts()
        l_c = loss_fn(p_cpu, train)
    loss_err = abs(float(l_d) - float(l_c)) / abs(float(l_c))
    emit("families", part="a_card_vs_cpu", nvidia_smi=smi, arch=arch, cut=cut,
         n_layers=c.n_layers, n_enc_layers=c.n_enc_layers, d_model=c.d_model,
         params=base.n_params(registry.get_api(c).specs()), dtype="float32", tf32=False,
         batch=k["batch"], prompt=k["prompt"], steps=k["steps"], tol=LOGITS_TOL,
         logits_max_abs_err=worst_logits, cache_max_abs_err=worst, near_ties=near_ties,
         loss=float(l_c), loss_rel_err=loss_err, loss_tol=TRAIN_TOL["loss"],
         launches_prefill=n_prefill, launches_loss=n_loss)
    check(loss_err <= TRAIN_TOL["loss"], f"{arch} loss: card against CPU {loss_err}")
    want = flash_per_forward(c)
    check(n_prefill["flash_attention_fwd"] == want and n_steps == n_prefill
          and n_loss["flash_attention_fwd"] == want,
          f"{arch} launches {n_prefill} in the prefill, {n_steps} after the steps, {n_loss} "
          f"in the loss; want {want} flash launches in each pass and none in a step")


def families_serve(dev, smi, arch, seed, batch=FAM_BATCH, steps=FAM_STEPS):
    """(b) make_prefill at ``arch``'s published widths and depth in bf16 (the
    specs' dtypes: the recurrent states, gates and Mamba2's decay parameters
    f32), then ``steps`` make_serve_step steps from the padded cache. The
    counts are set to 0 just before the run and read just after the prefill
    and after the steps. Then the host syncs of one decode step, a profiled
    prefill and a profiled decode step. Returns the run's flash launches."""
    cfg, mod, _, prompt = FAMILIES[arch]
    api = registry.get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = base.materialize(api.specs(), torch.Generator(device=dev).manual_seed(0), device=dev)
    init_peak = torch.cuda.max_memory_allocated()
    data = {n: v.to(dev) for n, v in
            family_batch(cfg, np.random.default_rng(seed), batch, prompt).items()}
    prefill, step = serve_step.make_prefill(cfg), serve_step.make_serve_step(cfg)
    # warm-up (cuBLAS handles, the kernel's first load), outside the counted run
    short = {**data, "tokens": data["tokens"][:, :16]}
    tok, cache = prefill(params, short)
    step(params, pad_cache(cache, cfg, batch, 17), tok[:, None],
         torch.full((batch,), 16, dtype=torch.int32, device=dev))
    del cache
    r = timed_serve(mod, cfg, params, prefill, step, data, prompt, steps)
    tok, cache, prefill_s, decode_s = r["tok"], r["cache"], r["prefill_s"], r["decode_s"]
    n_prefill, n, peak = r["n_prefill"], r["n"], r["peak"]
    want = {"flash_attention_fwd": flash_per_forward(cfg), "tiered_decode_partial": 0,
            "quantize_pages": 0, "ordered_scatter_add": 0, "flash_attention_bwd": 0}
    check(n_prefill == want and n == want,
          f"{arch} launches {n_prefill} in the prefill and {n} in the run, want {want}")
    check(len(r["logits"]) == steps + 1
          and bool(torch.stack([torch.isfinite(x).all() for x in r["logits"]]).all()),
          f"{arch} non-finite logits")
    specs = {n: (sp.shape, sp.dtype) for n, sp in
             base.tree_paths(api.init_cache_specs(batch, prompt + steps)).items()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in base.tree_paths(cache).items()}
    check(got == specs, f"{arch} cache {got}, want {specs}")
    pos = torch.full((batch,), prompt + steps, dtype=torch.int32, device=dev)
    (_, _), syncs = host_syncs(lambda: step(params, cache, tok[:, None], pos))
    emit("families", part="b_serve", nvidia_smi=smi, arch=arch, family=cfg.family,
         n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
         dtype="bfloat16", params=base.n_params(api.specs()), batch=batch, prompt=prompt,
         enc_len=cfg.enc_len if cfg.family == "encdec" else None, steps=steps,
         prefill_ms=prefill_s * 1e3, prompt_tokens_per_s=batch * prompt / prefill_s,
         decode_ms_per_step=decode_s * 1e3 / steps, decode_tokens_per_s=batch * steps / decode_s,
         init_max_memory_allocated=init_peak, max_memory_allocated=peak,
         launches_prefill=n_prefill, launches=n,
         flash_launches_per_decode_step=(n["flash_attention_fwd"]
                                         - n_prefill["flash_attention_fwd"]) / steps,
         host_syncs_per_decode_step=len(syncs), host_syncs_by_line=dict(Counter(syncs)))
    # a profiled prefill: whole for whisper; for the recurrent families over the
    # first FAM_PROFILE_PROMPT tokens (every token costs the same host-issued step)
    n_tok = prompt if cfg.family == "encdec" else FAM_PROFILE_PROMPT
    part = {**data, "tokens": data["tokens"][:, :n_tok]}
    wall_ms, device_ms, cpu_ms = profiled(lambda: prefill(params, part))
    busy = sum(device_ms.values())
    emit("families", part="b_profile_prefill", nvidia_smi=smi, arch=arch, batch=batch,
         prompt=n_tok, wall_ms=wall_ms, device_busy_ms=busy or None,
         device_busy_share=busy / wall_ms if busy else None,
         top_device_ms=top(device_ms, 1, 10), top_host_inclusive_ms=top(cpu_ms, 1, 8))
    wall_ms, device_ms, cpu_ms = profiled(lambda: step(params, cache, tok[:, None], pos))
    busy = sum(device_ms.values())
    emit("families", part="b_profile_decode", nvidia_smi=smi, arch=arch, batch=batch,
         cache_len=prompt + steps, wall_ms=wall_ms, device_busy_ms=busy or None,
         device_busy_share=busy / wall_ms if busy else None,
         top_device_ms=top(device_ms, 1, 10), top_host_inclusive_ms=top(cpu_ms, 1, 8))
    return n["flash_attention_fwd"]


def families_train(dev, smi, seed):
    """(c) The flash kernel's autograd entry at whisper's encoder and cross
    shapes (non-causal, Sq = Sk = 1500 and 416 x 1500) against the plain
    attention's gradients, f32 and bf16; (d) one make_train_step step of each
    family at its (a) depth cut and published widths in f32 on
    FAM_TRAIN_PROMPT tokens, on the card and on the CPU from the same
    numpy-made parameters and batch
    (``train_card_vs_cpu``). Returns (c)'s errors by shape and (d)'s flash
    launches by arch."""
    entry = {label: autograd_entry_check(dev, smi, WHISPER_FLASH[label], "families",
                                         f"c_autograd_entry_{label}", 21)[0]
             for label in ("whisper_enc", "whisper_cross")}
    torch.cuda.empty_cache()
    launches = {}
    for arch, (cfg, _, cut, _) in FAMILIES.items():
        c = cfg.with_(**cut, dtype=torch.float32)
        batch = family_batch(c, np.random.default_rng(seed), FAM_CMP["batch"], FAM_TRAIN_PROMPT,
                             labels=True)
        launches[arch] = train_card_vs_cpu(dev, c, smi, batch=batch, seed=seed,
                                           phase="families", part="d_train_card_vs_cpu")
        torch.cuda.empty_cache()
    return entry, launches


def phase_families(dev, smi, seed):
    """whisper-medium, xlstm-125m and zamba2-2.7b on the card (see the module
    docstring, phase 14): (a) card against CPU in f32 at a cut depth, (b) the
    main serving path at full width and depth in bf16, (c) the autograd entry
    at whisper's non-causal shapes, (d) one training step each, card against
    CPU. Returns (b)'s flash launches by arch, with whisper's training step's
    under "whisper_train", and (c)'s errors."""
    for arch in FAMILIES:
        families_card_vs_cpu(dev, smi, arch, seed)
        torch.cuda.empty_cache()
    launches = {}
    for arch in FAMILIES:
        launches[arch] = families_serve(dev, smi, arch, seed)
        torch.cuda.empty_cache()
    entry, train_launches = families_train(dev, smi, seed)
    launches["whisper_train"] = train_launches["whisper-medium"]["flash_attention_fwd"]
    BWD_BY_PATH["whisper_train"] = train_launches["whisper-medium"]["flash_attention_bwd"]
    return launches, entry


# --------------------------------------------------------------------------
# the dry run (launch/dryrun.py) on the card machine, held against real steps
# --------------------------------------------------------------------------
DRYRUN_JOBS = 7  # the dry run's processes, one arch each, on the machine's 8 cores
# the recurrent families' train and prefill: one host step per token (at
# 1,024, xlstm's train cell took 35 s of the script)
DRYRUN_CUT_SEQ = 512
DRYRUN_KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
RECURRENT = ("ssm", "hybrid")
# all that the bytes requested from the allocator hold beyond the live
# tensors the tracker sees: cuBLAS's and cuBLASLt's workspaces, held from the
# first product on, and up to 1 MiB asked for below the dispatcher
CUBLAS_WORKSPACE_BYTES = 64 * 2**20
UNSEEN_SLACK_BYTES = 2**20


def dryrun_cli(arch):
    """``python -m repro_torch.launch.dryrun --arch arch --mesh all --force``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--mesh", "all", "--force"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def dryrun_records(smi, runs, wall):
    """(a) The whole dry run's records read back (``runs``: each arch's
    ``dryrun_cli`` result): per mesh the cells ok, skipped (long_500k for the
    non-recurrent families, as the reference skips it) and failed (none
    allowed); and the h100_1x1 table. Returns the h100_1x1 records by (arch,
    shape)."""
    for arch, r in runs.items():
        check(r.returncode == 0, f"dry run of {arch}: rc {r.returncode}\n{r.stdout[-2000:]}"
                                 f"\n{r.stderr[-2000:]}")
    by_mesh = {}
    for _, (mesh_name, _) in dryrun.MESHES.items():
        recs = [json.loads((dryrun.RESULTS / mesh_name / f"{a}__{sh}.json").read_text())
                for a in dryrun.ARCHS for sh in dryrun.SHAPES]
        n = Counter(r["status"] for r in recs)
        skipped = sorted((r["arch"], r["shape"]) for r in recs if r["status"] == "skipped")
        want_skip = sorted((a, "long_500k") for a, c in dryrun.ARCHS.items()
                           if c.family not in RECURRENT)
        emit("dryrun", part="a_mesh", nvidia_smi=smi, mesh=mesh_name, ok=n["ok"],
             skipped=n["skipped"], failed=n["fail"], wall_s=wall,
             count_s=sum(r.get("count_s", 0) for r in recs))
        check(n["fail"] == 0 and n["ok"] + n["skipped"] == len(recs) and skipped == want_skip,
              f"dry run on {mesh_name}: {dict(n)}, skipped {skipped}")
        by_mesh[mesh_name] = {(r["arch"], r["shape"]): r for r in recs if r["status"] == "ok"}
    card = by_mesh[dryrun.CARD_MESH]
    table = {a: {sh: dict(args_gb=r["per_device_bytes"]["arguments"] / 1e9,
                          peak_gb=r["peak_bytes_estimate"] / 1e9, fits=r["fit"]["fits"])
                 for (a2, sh), r in card.items() if a2 == a} for a in dryrun.ARCHS}
    any_rec = next(iter(card.values()))
    emit("dryrun", part="a_fit_table", nvidia_smi=smi, mesh=dryrun.CARD_MESH,
         device=any_rec["fit"]["device"], device_bytes=any_rec["fit"]["device_bytes"],
         headroom_bytes=any_rec["fit"]["headroom_bytes"], table=table)
    return card


def card_args(cfg, shape, dev):
    """The cell's arguments on the card, laid out as ``dryrun.abstract_args``:
    parameters drawn from seed 0, zero AdamW moments for training, tokens,
    labels and frames drawn on the card, a decode cache from its specs' init
    and the position of its last slot."""
    api = registry.get_api(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = base.materialize(api.specs(), gen, device=dev)
    b, s = shape.global_batch, shape.seq_len

    def ints(shape_):
        return torch.randint(0, cfg.vocab, shape_, generator=gen, device=dev, dtype=torch.int32)

    if shape.kind == "decode":
        inputs = {"tokens": ints((b, 1)),
                  "pos": torch.full((b,), s - 1, dtype=torch.int32, device=dev),
                  "cache": base.materialize(api.init_cache_specs(b, s), gen, device=dev)}
    else:
        abstract = registry.input_specs(cfg, shape)
        inputs = {k: ints(v.shape) if v.dtype == torch.int32 else
                  torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
                  for k, v in abstract.items()}
    return {"params": params, "opt_state": optim.init(params) if shape.kind == "train" else None,
            "inputs": inputs}


def dryrun_cell(dev, smi, cfg, shape, cuts, rec):
    """(b) One cell on the card, where its dry-run record ``rec`` says it
    fits: its arguments materialized (their bytes must equal the record's
    per-device argument bytes, leaf shapes and dtypes its abstract ones), one
    step under FlopCounterMode where the step has no per-token host loop
    (its count must equal the record's), and one timed step: achieved
    TFLOP/s, peak memory beside the estimate, flash launches (forward and
    backward). Returns the timed step's flash launches, or None where the
    cell was ruled out."""
    head = dict(nvidia_smi=smi, arch=cfg.arch, shape=shape.name, kind=shape.kind,
                batch=shape.global_batch, seq=shape.seq_len, cuts=cuts,
                per_device_bytes=rec["per_device_bytes"], peak_estimate=rec["peak_bytes_estimate"],
                headroom_bytes=rec["fit"]["headroom_bytes"],
                device_bytes=rec["fit"]["device_bytes"],
                flops=rec["step_flops_global"])
    if not rec["fit"]["fits"]:
        emit("dryrun", part="b_ruled_out", **head)
        return None
    torch.cuda.empty_cache()
    args = card_args(cfg, shape, dev)
    abstract = dryrun.abstract_args(cfg, shape)
    check([(tuple(t.shape), t.dtype) for t in base.tree_leaves(args) if t is not None]
          == [(tuple(t.shape), t.dtype) for t in base.tree_leaves(abstract) if t is not None],
          f"{cfg.arch} {shape.name}: the card's arguments are not the abstract ones")
    nbytes = dryrun.tree_bytes(args)
    check(nbytes == rec["per_device_bytes"]["arguments"],
          f"{cfg.arch} {shape.name}: {nbytes} bytes on the card, the dry run "
          f"{rec['per_device_bytes']['arguments']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card_flops = card_live = None
    if not (cfg.family in RECURRENT and shape.kind != "decode"):
        # also the warm-up; the live bytes the estimate's tracker sees on the
        # card part the estimate's misses into what passes through PyTorch's
        # dispatcher and what kernels allocate inside
        live = dryrun.LiveBytes()
        live.track(args)
        with FlopCounterMode(display=False) as fc, live:
            dryrun.run_step(cfg, shape, args)
            torch.cuda.synchronize()
        card_flops, card_live = int(fc.get_total_flops()), live.peak
    n0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dryrun.run_step(cfg, shape, args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    flash, flash_bwd = flash_attention_fwd.launches - n0, flash_attention_bwd.launches - b0
    peak = torch.cuda.max_memory_allocated()
    # what was asked for, before the allocator rounds blocks up (to 512 bytes,
    # and by its default settings up to 1 MiB more where it does not split one)
    requested = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    want = flash_per_forward(cfg) * (2 if shape.kind == "train" and cfg.remat else 1)
    want_bwd = flash_per_forward(cfg) if shape.kind == "train" else 0
    if shape.kind == "decode":
        want = 0
    emit("dryrun", part="b_cell", **head, argument_bytes_on_card=nbytes, card_flops=card_flops,
         ms=ms, achieved_tflop_per_s=rec["step_flops_global"] / (ms / 1e3) / 1e12,
         max_memory_allocated=peak, peak_over_estimate=peak / rec["peak_bytes_estimate"],
         requested_bytes_peak=requested, max_memory_reserved=torch.cuda.max_memory_reserved(),
         tracked_peak_on_card=card_live, flash_launches=flash, flash_bwd_launches=flash_bwd)
    # what the tracker cannot see (kernels' inside allocations but softmax's,
    # which inside_bytes adds) is at most cuBLAS's workspace
    check(card_live is None
          or 0 <= requested - card_live <= CUBLAS_WORKSPACE_BYTES + UNSEEN_SLACK_BYTES,
          f"{cfg.arch} {shape.name}: {requested} bytes requested at the peak, tracked on the "
          f"card {card_live} (inside_bytes included): more than cuBLAS's workspace apart")
    check(card_flops is None or card_flops == rec["step_flops_global"],
          f"{cfg.arch} {shape.name}: {card_flops} FLOPs counted on the card, "
          f"{rec['step_flops_global']} on meta")
    check(flash == want and flash_bwd == want_bwd,
          f"{cfg.arch} {shape.name}: {flash} flash launches, want {want}; {flash_bwd} "
          f"backward, want {want_bwd}")
    del args
    torch.cuda.empty_cache()
    return flash


def phase_dryrun(dev, smi):
    """The dry run on the card machine (see the module docstring, phase 15):
    (a) the whole dry run, all three meshes, DRYRUN_JOBS processes, while
    this process takes the dry run's records of (b)'s cut cells; (b) for each
    arch whose parameters fit the card, one cell per applicable kind at
    published widths and depth with global_batch cut to 1 (the recurrent
    families' train and prefill also cut to DRYRUN_CUT_SEQ tokens), and every
    whole cell the dry run says fits (but the recurrent families' train and
    prefill, 32,768 host steps), each run where the dry run says it fits.
    The counts are set to 0 just before (b) and read just after it. Returns
    (b)'s launch counts."""
    total, _ = dryrun.card_bytes()
    meta = make_host_mesh("meta")
    cells = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRYRUN_JOBS) as pool:
        runs = pool.map(dryrun_cli, dryrun.ARCHS)  # submitted now, read below
        for arch, cfg in dryrun.ARCHS.items():
            if dryrun.tree_bytes(base.abstract(registry.get_api(cfg).specs())) > total:
                continue
            for kind, name in DRYRUN_KINDS.items():
                shape = dryrun.SHAPES[name]
                cut = replace(shape, global_batch=1)
                cuts = {"global_batch": [shape.global_batch, 1]}
                if cfg.family in RECURRENT and kind != "decode":
                    cut = replace(cut, seq_len=DRYRUN_CUT_SEQ)
                    cuts["seq_len"] = [shape.seq_len, DRYRUN_CUT_SEQ]
                cells.append((cfg, cut, cuts, dryrun.dry_cell(cfg, cut, meta, dryrun.CARD_MESH)))
        runs = dict(zip(dryrun.ARCHS, runs))
    card = dryrun_records(smi, runs, time.perf_counter() - t0)
    for (arch, name), rec in card.items():
        cfg, shape = dryrun.ARCHS[arch], dryrun.SHAPES[name]
        if not rec["fit"]["fits"]:
            continue
        if cfg.family in RECURRENT and shape.kind != "decode":
            emit("dryrun", part="b_not_run_whole", nvidia_smi=smi, arch=arch, shape=name,
                 reason="one host step per token")
        else:
            cells.append((cfg, shape, {}, rec))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_counts()
    ran = [dryrun_cell(dev, smi, *cell) for cell in cells]
    n = counts()
    emit("dryrun", part="b_summary", nvidia_smi=smi, cells=len(cells),
         run=sum(f is not None for f in ran), ruled_out=sum(f is None for f in ran),
         seconds=time.perf_counter() - t0, launches=n)
    BWD_BY_PATH["dryrun_cells"] = n["flash_attention_bwd"]
    return n


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


# the components of obs_lat_comp that no Lindley prefix sum feeds: held by the
# strict rule in a lattice run, where lindley_loose loosens the leaf
NON_LINDLEY = [ssd_obs.COMP_SENSE, ssd_obs.COMP_RETRY, ssd_obs.COMP_XFER, ssd_obs.COMP_REBUILD]


def ssd_lockstep(cfg, trace, n_chunks, dev, knobs=None, every=1, exact=()):
    """The card against the port on the CPU, step by step from the same
    trace (and ``knobs``, a ``RunKnobs`` on the CPU, as a sweep run takes
    them): both states and chunk metrics compared after every ``every``-th
    chunk and the last by the comparison rule (the first divergence, its
    chunk and leaves, is kept), then both summaries; check_invariants on both
    final states. In a lattice run ``obs_lat_comp`` takes ``lindley_loose``
    but for its NON_LINDLEY components, held strictly. For each state leaf
    named in ``exact``: whether it was bit-equal at every compared chunk, and
    its largest relative gap (|card - CPU| / |CPU|) over them."""
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
    gaps = {name: dict(bit_equal=True, max_rel_gap=0.0) for name in exact}
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
            if lattice and s_c.obs_lat_comp.numel():
                bad += C.compare_leaves(["obs_lat_comp (non-Lindley components)"],
                                        [s_c.obs_lat_comp[:, NON_LINDLEY]],
                                        [s_d.obs_lat_comp[:, NON_LINDLEY]])
            if bad:
                first = dict(chunk=c, leaves=bad[:6])
        for name, g in gaps.items():
            a, b = getattr(s_c, name), getattr(s_d, name).cpu()
            g["bit_equal"] &= torch.equal(a, b)
            if a.numel():
                rel = (a - b).abs() / a.abs().clamp_min(1e-30)
                g["max_rel_gap"] = max(g["max_rel_gap"], float(rel.max()))
    ssd_state.check_invariants(s_c, cfg, "cpu")
    ssd_state.check_invariants(s_d, cfg, "card")
    loose = C.lindley_loose(s_c.obs_lat_mode.numpy()) if lattice else {}
    summ_c, summ_d = ssd_engine.summarize(s_c, cfg), ssd_engine.summarize(s_d, cfg)
    bad_summary = C.compare_summaries(summ_c, summ_d, loose=loose)
    return dict(chunks=len(chunks), compared=compared, first_divergence=first,
                summary_mismatches=bad_summary, exact=gaps), summ_d


# (d) tests/test_torch_wearout.py::TestParityRebuild's cell: the tiny
# geometry, Baseline, worn (P/E 900), obs_level "full", read failures with
# parity rebuild; 8,192 zipf-1.2 reads, chunks of 128, the legacy channel model
PARITY_REBUILD = dict(policy=ssd_geometry.BASELINE, initial_pe=900, obs_level="full",
                      max_read_retries=2, read_fail_rate=0.01, fault_seed=1,
                      parity_rebuild=True)
PARITY_REBUILD_READS = 8_192
OBS_SUMS = ("obs_ts", "obs_lat_comp")  # the float sums of ops.at_add_in_order


def one_hot_sums(dst, idx, src):
    """The card's obs sums before the ordered kernel, kept to measure what it
    repairs: each row's lanes summed through one-hot masks (``segment_sum``),
    then added into ``dst``; the CPU's lane order unchanged."""
    if dst.device.type == "cpu":
        return ordered_scatter_add_plain(dst, port_ops.drop_index(idx, dst.shape[0]).reshape(-1),
                                         port_ops._rows(src, idx, dst))
    n = dst.shape[0]
    return dst + port_ops.segment_sum(port_ops._rows(src, idx, dst),
                                      port_ops.drop_index(idx, n).reshape(-1), n)


def ssd_parity_rebuild(dev):
    """(d) in lockstep, card against CPU, every chunk by the strict rule, with
    ``obs_ts`` and ``obs_lat_comp`` bit for bit; 2 ordered_scatter_add
    launches a chunk on the card (obs "full") and none on the CPU. First the
    same run with the card's former one-hot sums (``one_hot_sums``), whose
    largest gaps in those two leaves are measured and not held."""
    cfg = ssd_geometry.tiny_config(**PARITY_REBUILD)
    check(cfg.chan_model == "legacy" and cfg.chunk == 128,
          f"(d) expects the legacy channel model and chunks of 128: {cfg.chan_model}, {cfg.chunk}")
    trace = ssd_workload.zipf_read_trace(cfg, PARITY_REBUILD_READS, 1.2, seed=1)
    real = port_ops.at_add_in_order
    port_ops.at_add_in_order = one_hot_sums
    try:
        n0 = ordered_scatter_add.launches
        before, _ = ssd_lockstep(cfg, trace, None, dev, exact=OBS_SUMS)
        check(ordered_scatter_add.launches == n0, "(d) the one-hot run reached the kernel")
    finally:
        port_ops.at_add_in_order = real
    n0, t0 = ordered_scatter_add.launches, time.perf_counter()
    cmp, summ = ssd_lockstep(cfg, trace, None, dev, exact=OBS_SUMS)
    wall, launches = time.perf_counter() - t0, ordered_scatter_add.launches - n0
    check(cmp["first_divergence"] is None and not cmp["summary_mismatches"],
          f"(d) the card diverges from the CPU: {cmp}")
    check(all(g["bit_equal"] for g in cmp["exact"].values()),
          f"(d) obs sums not bit-equal to the CPU's: {cmp['exact']}")
    check(launches == 2 * cmp["chunks"], f"(d) {launches} ordered_scatter_add launches "
          f"for {cmp['chunks']} chunks at obs_level full")
    check(summ["rebuilds"] > 0, f"(d) no parity rebuild fired: {summ['rebuilds']}")
    # one launch a chunk at obs_level "counters" (the time series only)
    n0 = ordered_scatter_add.launches
    ssd_engine.run(replace(cfg, obs_level="counters"),
                   {k: v[:4] for k, v in trace.items()}, device=dev)
    check(ordered_scatter_add.launches - n0 == 4,
          f"(d) {ordered_scatter_add.launches - n0} launches for 4 chunks at obs_level counters")
    return dict(run="d_baseline_parity_rebuild_tiny", n_blocks=cfg.n_blocks, chunk=cfg.chunk,
                chunks=cmp["chunks"], requests=PARITY_REBUILD_READS, chan_model=cfg.chan_model,
                obs_level=cfg.obs_level, rebuilds=summ["rebuilds"],
                uncorrectable_reads=summ["uncorrectable_reads"],
                ordered_scatter_add_launches=launches, launches_per_chunk=launches / cmp["chunks"],
                card_vs_cpu=cmp, lockstep_wall_s=wall,
                one_hot_before=dict(exact=before["exact"],
                                    first_divergence=before["first_divergence"],
                                    summary_mismatches=before["summary_mismatches"]))


def phase_ssd(dev):
    """Layer A on the card (see the module docstring, phase 11). Returns the
    summaries, and the open-loop run's (config, final state) by name."""
    out, states = {}, {}
    for name, cfg, trace, cmp_chunks in ssd_runs():
        n_chunks = trace["lpn"].shape[0]
        if not out:  # a short warm-up run: the first run pays one-time costs
            ssd_engine.run(cfg, {k: v[:2] for k, v in trace.items()}, device=dev)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0, t0 = ordered_scatter_add.launches, time.perf_counter()
        s, m = ssd_engine.run(cfg, trace, device=dev)
        torch.cuda.synchronize()
        wall, ordered = time.perf_counter() - t0, ordered_scatter_add.launches - n0
        per_chunk = {"off": 0, "counters": 1, "full": 2}[cfg.obs_level]
        check(ordered == per_chunk * n_chunks, f"{name}: {ordered} ordered_scatter_add launches "
              f"over {n_chunks} chunks at obs_level {cfg.obs_level}")
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
             ordered_scatter_add_launches=ordered,
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
    emit("ssd", **ssd_parity_rebuild(dev))
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
    """The experiment sweep on the card (see the module docstring, phase 12).
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


# --------------------------------------------------------------------------
# the parallel layer at runtime, on a one-rank NCCL group
# --------------------------------------------------------------------------
PARALLEL_STEPS = 4  # (b): full-width steps of each run
PARALLEL_DIR = ROOT / "build" / "chip_smoke_parallel"  # git-ignored: the group's rendezvous file
# (c): granite's MoE layer at its published widths on 4 x 2048 tokens, at the
# capacity factor E / K, where neither dispatch can drop (every expert holds
# all tokens); tolerances relative to each tensor's largest entry, the kernels'
EP_TOKENS = (4, PROMPT)
EP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
EP_ITERS = 5  # timed forward + backward calls of each dispatch
# (e): the sweep phase's canonical grid cut to its RARO group (four runs) and
# from 80,000 requests to 16,384, so that two sweeps of it take seconds
PARALLEL_SWEEP = dict(policies=(ssd_geometry.RARO,), n_requests=16_384)


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def parallel_train(dev, cfg, mesh=None):
    """(b) ``launch.train.run`` at the train phase's shape, ``PARALLEL_STEPS``
    steps: (params, hist, step records, launch counts of the run)."""
    records = []
    with recorded_steps(records):
        reset_counts()
        params, hist = train.run(cfg.arch, smoke=False, steps=PARALLEL_STEPS, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ, log_every=1, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        n = counts()
    return params, hist, records, n


def parallel_data_mean(dev, cfg, params, mesh, n_iter=5):
    """(b) The data-parallel mean that ``make_train_step`` makes over data
    axes of more than one rank (one data rank skips it), here over the
    one-rank NCCL group: ``collectives.mean_over`` on the loss and gradients
    of one step at ``params`` (the last batch of (b)'s run), which must come
    back bit for bit in their dtypes; ``n_iter`` calls, each timed between
    two synchronizes (the first sets up NCCL's communicator)."""
    api = registry.get_api(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(PARALLEL_STEPS - 1).items()}
    loss, grads = train_step.value_and_grad(api.loss_fn, params, batch, api.idle_params)
    tensors = [loss, *base.tree_leaves(grads)]
    ms = []
    for _ in range(n_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collectives.mean_over(tensors, mesh.data_group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out, tensors)),
              "(b) mean_over on the one-rank group changed a gradient or the loss")
        del out
    return dict(tensors=len(tensors), bytes=sum(t.numel() * t.element_size() for t in tensors),
                ms=ms, bit_equal=True)


def moe_fwd_bwd(fn, p, x, dy, daux):
    """y, aux and the gradients (x's, then p's leaves) of
    ``<y, dy> + daux * aux`` for ``fn(p, x) -> (y, aux)``."""
    leaves = [t.detach().requires_grad_() for t in base.tree_leaves(p)]
    xr = x.detach().requires_grad_()
    y, aux = fn(base.tree_unflatten(p, leaves), xr)
    ((y.float() * dy).sum() + daux * aux).backward()
    return [y.detach(), aux.detach(), xr.grad] + [t.grad for t in leaves]


def timed_ms(fn, n_iter):
    """Mean ms of ``fn()`` back to back, CUDA events around the loop."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n_iter):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n_iter


@contextlib.contextmanager
def all_to_all_events(events):
    """While active, each ``torch.distributed.all_to_all_single`` call is
    bracketed by two CUDA events appended to ``events``."""
    real = dist.all_to_all_single

    def timed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    dist.all_to_all_single = timed
    try:
        yield
    finally:
        dist.all_to_all_single = real


def parallel_ep(dev, mesh):
    """(c) ``moe_apply_ep`` on the one-rank mesh (tp = 1) against
    ``moe_apply`` at granite's widths, forward and backward, f32 and bf16."""
    cfg = granite_moe_3b_a800m.CONFIG
    cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    b, s = EP_TOKENS
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=dev).manual_seed(0)
    p_spec = base.materialize(moe.moe_specs(cfg), gen, device=dev)  # router f32, experts bf16
    x0 = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    dy = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    daux = 2.0

    # nothing drops: each expert's load within moe_apply's capacity and within
    # moe_apply_ep's per-expert rows, and every assignment within its send buffer
    logits = x0.reshape(n, -1) @ p_spec["router"]
    _, idx = port_ops.top_k(torch.softmax(logits, -1), k)
    load = int(torch.bincount(idx.reshape(-1).long(), minlength=e).max())
    cap_send = -(-int(n * k * cfg.capacity_factor) // 8) * 8  # moe_apply_ep's at tp = 1
    cap_e = -(-(-(-cap_send // e)) // 8) * 8
    check(load <= min(moe.capacity(cfg, n), cap_e) and n * k <= cap_send,
          f"(c) drops: the largest expert load {load}, capacities {moe.capacity(cfg, n)}, "
          f"{cap_e}, send {cap_send} for {n * k} assignments")

    def ep(p, x):
        return moe.moe_apply_ep(p, x, cfg, mesh)

    def plain(p, x):
        return moe.moe_apply(p, x, cfg)

    names = ["y", "aux", "x"] + list(base.tree_paths(p_spec))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        p = p_spec if dt == torch.bfloat16 else base.tree_map(lambda t: t.float(), p_spec)
        x = x0.to(dt)
        got = moe_fwd_bwd(ep, p, x, dy, daux)
        want = moe_fwd_bwd(plain, p, x, dy, daux)
        errs = {nm: _rel_err(g, w) for nm, g, w in zip(names, got, want)}
        check(all(math.isfinite(v) and v <= EP_TOL[dt] for v in errs.values()),
              f"(c) moe_apply_ep vs moe_apply, {dt}: {errs}")
        del got, want
        ep_ms = timed_ms(lambda: moe_fwd_bwd(ep, p, x, dy, daux), EP_ITERS)
        plain_ms = timed_ms(lambda: moe_fwd_bwd(plain, p, x, dy, daux), EP_ITERS)
        events = []
        torch.cuda.synchronize()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with all_to_all_events(events):
            a.record()
            moe_fwd_bwd(ep, p, x, dy, daux)
            z.record()
        z.synchronize()
        a2a_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        out[str(dt).replace("torch.", "")] = dict(
            rel_err=errs, tol=EP_TOL[dt], ep_fwd_bwd_ms=ep_ms, moe_apply_fwd_bwd_ms=plain_ms,
            all_to_all_calls=len(events), all_to_all_ms=a2a_ms,
            all_to_all_share=a2a_ms / a.elapsed_time(z))
    return dict(arch=cfg.arch, d_model=cfg.d_model, n_experts=e, top_k=k, moe_d_ff=cfg.moe_d_ff,
                tokens=list(EP_TOKENS), capacity_factor=cfg.capacity_factor, tp=1,
                largest_expert_load=load, capacities=dict(moe_apply=moe.capacity(cfg, n),
                                                          cap_send=cap_send, cap_e=cap_e),
                dropped=0, **out)


def parallel_compressed(dev, params, cfg, mesh):
    """(d) ``compressed_allreduce`` over "data" of the one-rank mesh, over each
    gradient leaf of one tinyllama-1.1b step (batch 1 x 2048, the run's final
    parameters), twice: without error feedback, then with the first call's
    residual. The mean must equal ``decompress(compress(g))`` bit for bit, and
    each residual the CPU's."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
    _, grads = train_step.value_and_grad(registry.get_api(cfg).loss_fn, params, batch)
    leaves = base.tree_leaves(grads)
    del grads
    errs = [None] * len(leaves)
    out = {}
    with set_mesh(mesh):
        for label in ("no_err", "err"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [compression.compressed_allreduce(g, e, "data") for g, e in zip(leaves, errs)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            for g, e, (mean, new_err) in zip(leaves, errs, res):
                q, scale, _ = compression.compress(g, e)
                check(torch.equal(mean, compression.decompress(q, scale)),
                      f"(d) {label}: the one-rank mean is not decompress(compress(g))")
                _, _, cpu_err = compression.compress(g.cpu(), None if e is None else e.cpu())
                check(torch.equal(new_err.cpu(), cpu_err), f"(d) {label}: the residual != CPU's")
            errs = [new_err for _, new_err in res]
            out[f"{label}_ms"] = ms
            del res
    numel = sum(g.numel() for g in leaves)
    return dict(leaves=len(leaves), elements=numel, wire_bytes=numel + 4 * len(leaves),
                f32_bytes=4 * numel, wire_over_f32=(numel + 4 * len(leaves)) / (4 * numel),
                mean_bit_equal=True, residual_equals_cpu=True, **out)


def parallel_sweep():
    """(e) The sweep's RARO group (``PARALLEL_SWEEP``'s cut) on two entries
    of the card, a thread each, against one device."""
    spec = replace(raro_ssd.tail_latency_sweep(), **PARALLEL_SWEEP)
    t0 = time.perf_counter()
    one = ssd_sweep.run_sweep(spec)
    t1 = time.perf_counter()
    two = ssd_sweep.run_sweep(spec, devices=("cuda:0", "cuda:0"))
    t2 = time.perf_counter()
    ssd_sweep.assert_results_identical(one, two)
    return dict(scenario=spec.scenario, runs=len(one), n_requests=spec.n_requests,
                cut="the RARO group alone; 80,000 requests -> 16,384", one_device_s=t1 - t0,
                two_entries_s=t2 - t1, identical=True)


# (f): tensor parallelism over two processes on the one card, a gloo group
# (NCCL refuses two ranks on one GPU; gloo's all-reduce and all-gather take
# CUDA tensors through the host), on the (1, 2) ("data", "model") mesh
TP_WORLD = 2
TP_CMP = dict(n_layers=2, steps=2, batch=2, seq=256, lr=1e-3)  # (f1): f32, 2 layers
TP_STEPS, TP_BATCH = 3, 2  # (f2): full depth in bf16, 3 steps of 2 x 2048 tokens
TP_TIMEOUT_S = 300
# (f1)'s and (g1)'s tolerances, the CPU tests' for f32 steps taken two ways:
# losses rtol 1e-5; each step's grad norm rtol 1e-5, which sees a gradient of
# the right sign and the wrong size (a partial cotangent not summed over the
# ranks), where AdamW's parameters do not (its first steps move each entry by
# about lr * sign(g)); parameters rtol 1e-5 plus atol 1e-4, as
# tests/test_torch_train.py holds parameters after steps at lr 1e-3 (AdamW
# divides each entry by its own root mean square plus eps, so an entry whose
# gradient nearly cancels steps by an amount that the sums' order moves; on an
# H100 one entry of 524,288 in layer 0's wk came out 1.3e-5 apart). (f1) and
# (g1) take launch.train.run's warmup of 20, steps of 5e-5 and 1e-4, so 1e-4
# is about one step: an entry whose gradient cancels to ~eps steps apart by
# a share of a step at any lr (at the full lr, deepseek-v3's embed.table had
# 340 entries of 463,339,520 up to 6.7e-4 apart after steps of 1e-3 and
# 9.7e-4), and the parameters cannot be held to a tenth of one.
# (f2): the losses rtol 2e-3, as the CPU tests hold bf16 losses
TP_TOL = dict(loss=1e-5, grad_norm=1e-5, params_rtol=1e-5, params_atol=1e-4, bf16_loss=2e-3)


@contextlib.contextmanager
def f32_params():
    """``base.materialize`` draws every parameter in float32 while active."""
    orig = base.materialize
    base.materialize = lambda *a, **kw: orig(*a, **{**kw, "dtype": torch.float32})
    try:
        yield
    finally:
        base.materialize = orig


@contextlib.contextmanager
def timed_collectives(totals):
    """While active, each ``torch.distributed.all_reduce`` and ``all_gather``
    runs between two synchronizes, and its host ms and count are added to
    ``totals[name]`` (``ms``, ``calls``). With gloo on CUDA tensors the call
    copies them to the host, reduces or gathers there and copies back."""
    reals = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def timing(name, real):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            tot = totals.setdefault(name, dict(ms=0.0, calls=0))
            tot["ms"] += (time.perf_counter() - t0) * 1e3
            tot["calls"] += 1
            return out
        return timed

    for name, real in reals.items():
        setattr(dist, name, timing(name, real))
    try:
        yield
    finally:
        for name, real in reals.items():
            setattr(dist, name, real)


@contextlib.contextmanager
def sized_steps(bytes_):
    """While active, the first step of a ``train_step.make_train_step`` step
    function records in ``bytes_`` the bytes of the parameters, of their
    gradients (the parameters' shapes and dtypes) and of the AdamW state it
    receives."""
    make = train_step.make_train_step

    def sizing(*a, **kw):
        step = make(*a, **kw)

        def first(params, opt_state, batch):
            if not bytes_:
                bytes_.update(params=dryrun.tree_bytes(params), grads=dryrun.tree_bytes(params),
                              adamw_state=dryrun.tree_bytes(opt_state))
            return step(params, opt_state, batch)
        return first

    train_step.make_train_step = sizing
    try:
        yield
    finally:
        train_step.make_train_step = make


def tp_runs(dev, cfg, mesh=None, out=None):
    """(f1) and (f2) on ``mesh`` (None: one process): (f1) ``launch.train.run``
    of 2 layers at tinyllama's widths in f32, TP_CMP; (f2) the full model in
    bf16, TP_STEPS steps of TP_BATCH x 2048, each step timed between two
    synchronizes with its flash launches, and (on a mesh) the host ms inside
    the group's all-reduces and all-gathers; the parameters' and AdamW
    state's bytes as the first step receives them, and the peak of allocated
    memory. (f1)'s final parameters, gathered whole, are saved to ``out``
    (rank 0) or returned."""
    c = TP_CMP
    cmp_cfg = cfg.with_(n_layers=c["n_layers"], dtype=torch.float32)
    records1 = []
    with f32_params(), recorded_steps(records1):
        params, hist1 = train.run(cfg.arch, cfg=cmp_cfg, steps=c["steps"], batch=c["batch"],
                                  seq=c["seq"], lr=c["lr"], log_every=1, mesh=mesh, device=dev)
    params = {k: v.cpu() for k, v in base.tree_paths(
        sharding.gather_params(params, cmp_cfg, mesh)).items()}
    if out is not None and dist.get_rank() == 0:
        torch.save(params, out)
    records, bytes_, coll = [], {}, {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with sized_steps(bytes_), recorded_steps(records), (
            timed_collectives(coll) if mesh is not None else contextlib.nullcontext()):
        reset_counts()
        _, hist2 = train.run(cfg.arch, smoke=False, steps=TP_STEPS, batch=TP_BATCH,
                             seq=TRAIN_SEQ, log_every=1, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        n = counts()
    step_ms = [r["ms"] for r in records]
    return dict(f1_hist=hist1, f1_grad_norms=[r["grad_norm"] for r in records1],
                f1_params=None if out is not None else params,
                f2=dict(losses=[l for _, l in hist2], step_ms=step_ms,
                        flash_launches_per_step=[r["flash_launches"] for r in records],
                        launches=n, bytes=bytes_, max_memory_allocated=torch.cuda.max_memory_allocated(),
                        all_reduces=coll))


def _tp_rank(rank, world, rendezvous, out_dir):
    """One rank of (f), in a process of its own on the card: a gloo group
    from a file:// rendezvous, the (1, world) mesh over it, then ``tp_runs``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", init_method=f"file://{rendezvous}", rank=rank,
                           world_size=world, backend="gloo")
    try:
        mesh = make_mesh((1, world), ("data", "model"), dev)
        res = tp_runs(dev, tinyllama_1_1b.CONFIG, mesh, out_dir / "f1_params.pt")
        res["backend"] = dist.get_backend()
        torch.save(res, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, args, timeout_s, label):
    """``fn(rank, *args)`` in TP_WORLD processes on the card; raises if one
    fails or they outlast ``timeout_s``. Returns the wall seconds."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=args, nprocs=TP_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"chip_smoke: {label} did not end within {timeout_s} s")
    return time.perf_counter() - t0


def parallel_tp(dev, cfg, smi):
    """(f) tinyllama-1.1b's training step tensor-parallel over two processes
    on the card against one process: (f1) in f32, the losses and the final
    parameters gathered whole within TP_TOL; (f2) at full depth in bf16, the
    losses within 2e-3, 2 x n_layers flash launches a step on each rank at
    its heads (16 over 2 KV heads), each rank's bytes and peak beside the one
    process's. Returns the flash launches of (f2) over both ranks."""
    one = tp_runs(dev, cfg)
    torch.cuda.empty_cache()
    tp_dir = PARALLEL_DIR / "tp"
    shutil.rmtree(tp_dir, ignore_errors=True)
    tp_dir.mkdir(parents=True)
    wall_s = spawn_ranks(_tp_rank, (TP_WORLD, tp_dir / "rendezvous", tp_dir), TP_TIMEOUT_S, "(f)")
    ranks = [torch.load(tp_dir / f"rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]
    got = torch.load(tp_dir / "f1_params.pt")
    shutil.rmtree(tp_dir, ignore_errors=True)

    # (f1): f32, 2 layers, 2 steps, against one process
    want, t = one["f1_params"], TP_TOL
    losses = [[l for _, l in r["f1_hist"]] for r in ranks]
    loss_err = max(abs(a - b) / abs(b) for ls in losses for a, (_, b) in zip(ls, one["f1_hist"]))
    check(all(ls == losses[0] for ls in losses) and loss_err <= t["loss"],
          f"(f1) losses {losses} vs one process {one['f1_hist']}")
    norm_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["f1_grad_norms"], one["f1_grad_norms"]))
    check(len(ranks[0]["f1_grad_norms"]) == TP_CMP["steps"] and norm_err <= t["grad_norm"],
          f"(f1) grad norms {[r['f1_grad_norms'] for r in ranks]} vs one process "
          f"{one['f1_grad_norms']}")
    check(got.keys() == want.keys(), "(f1) the gathered parameters' leaves differ")
    worst = {}
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=t["params_rtol"], atol=t["params_atol"],
                                   msg=lambda m: f"(f1) {k}: {m}")
        worst[k] = float((got[k] - w).abs().max())
    f1 = dict(n_layers=TP_CMP["n_layers"], steps=TP_CMP["steps"], batch=TP_CMP["batch"],
              seq=TP_CMP["seq"], dtype="float32", loss_max_rel_err=loss_err,
              grad_norm_max_rel_err=norm_err,
              params_max_abs_err=max(worst.values()),
              worst_leaf=max(worst, key=worst.get), tol=t)

    # (f2): full depth, bf16
    per_step = 2 * cfg.n_layers  # the forward, and remat's recompute in the backward
    o2 = one["f2"]
    for i, r in enumerate(ranks):
        f2 = r["f2"]
        check(all(math.isfinite(l) for l in f2["losses"]), f"(f2) rank {i}: {f2['losses']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(f2["losses"], o2["losses"]))
        check(rel <= t["bf16_loss"], f"(f2) rank {i} losses {f2['losses']} vs {o2['losses']}")
        check(f2["flash_launches_per_step"] == [per_step] * TP_STEPS
              and f2["launches"]["flash_attention_fwd"] == per_step * TP_STEPS
              and f2["launches"]["flash_attention_bwd"] == cfg.n_layers * TP_STEPS,
              f"(f2) rank {i} flash launches {f2['flash_launches_per_step']}, {f2['launches']}")
        f2["loss_max_rel_err"] = rel
    check(ranks[0]["f2"]["losses"] == ranks[1]["f2"]["losses"], "(f2) the ranks' losses differ")

    def after_first(ms):
        return sum(ms[1:]) / (len(ms) - 1)

    rank_lines = []
    for i, r in enumerate(ranks):
        f2 = r["f2"]
        ms = after_first(f2["step_ms"])
        ar = f2["all_reduces"]["all_reduce"]
        rank_lines.append(dict(
            rank=i, losses=f2["losses"], loss_max_rel_err=f2["loss_max_rel_err"],
            step_ms=f2["step_ms"], ms_per_step_after_first=ms,
            flash_launches_per_step=f2["flash_launches_per_step"], launches=f2["launches"],
            bytes=f2["bytes"], bytes_over_one_process={
                k: v / o2["bytes"][k] for k, v in f2["bytes"].items()},
            max_memory_allocated=f2["max_memory_allocated"],
            peak_over_one_process=f2["max_memory_allocated"] / o2["max_memory_allocated"],
            all_reduce_calls=ar["calls"], all_reduce_ms=ar["ms"],
            all_reduce_share_of_steps=ar["ms"] / sum(f2["step_ms"])))
    line = dict(
        backend=ranks[0]["backend"], world=TP_WORLD, mesh=dict(data=1, model=TP_WORLD),
        device="one card, both ranks on cuda:0", spawn_to_end_s=wall_s, f1_f32=f1,
        f2_bf16=dict(arch=cfg.arch, n_layers=cfg.n_layers, heads_per_rank=cfg.n_heads // TP_WORLD,
                     kv_heads_per_rank=cfg.n_kv_heads // TP_WORLD, batch=TP_BATCH, seq=TRAIN_SEQ,
                     steps=TP_STEPS, remat=cfg.remat,
                     one_process=dict(losses=o2["losses"], step_ms=o2["step_ms"],
                                      ms_per_step_after_first=after_first(o2["step_ms"]),
                                      bytes=o2["bytes"],
                                      max_memory_allocated=o2["max_memory_allocated"]),
                     ranks=rank_lines,
                     note="two ranks share one card and gloo copies every all-reduce through "
                          "the host: these times are not tensor-parallel speed"))
    BWD_BY_PATH["parallel_tp"] = sum(r["f2"]["launches"]["flash_attention_bwd"] for r in ranks)
    return line, sum(r["f2"]["launches"]["flash_attention_fwd"] for r in ranks)


# (h): MoE over two data ranks, two processes on the card over gloo as in
# (f), on the (2, 1) mesh: granite-moe-3b-a800m at its published widths cut to
# 2 MoE layers, f32, capacity factor 0.5 (tokens drop), 2 x 256 tokens a rank,
# against one process on the whole batch (4 x 256): moe.moe_apply takes the
# capacity, the drops and the aux loss over the global batch.
MOE_DP = dict(n_layers=2, capacity_factor=0.5, batch=4, seq=256, steps=2)
MOE_DP_TOL = dict(loss=1e-5, grads_of_max=1e-5)


def moe_dp_cfg():
    return granite_moe_3b_a800m.CONFIG.with_(
        n_layers=MOE_DP["n_layers"], capacity_factor=MOE_DP["capacity_factor"],
        dtype=torch.float32)


@contextlib.contextmanager
def counted_drops(drops):
    """While active, each ``moe._slots`` call appends to ``drops`` the number
    of assignments it drops (slots at its buffer's end)."""
    real = moe._slots

    def slots(dest, n_dest, cap, before=None, rows=None):
        out = real(dest, n_dest, cap, before, rows)
        drops.append(int((out == n_dest * (cap if rows is None else rows)).sum()))
        return out

    moe._slots = slots
    try:
        yield
    finally:
        moe._slots = real


def moe_dp_steps(dev, mesh=None):
    """(h) on this rank of ``mesh`` (None: one process on the whole batch):
    MOE_DP["steps"] make_train_step steps from parameters drawn on the card
    from seed 0, each timed between two synchronizes with its flash launches,
    (on a mesh) the host ms inside gloo's all-reduces and all-gathers; the
    loss, the grad norm, the dropped assignments of each MoE layer's forward
    (remat recomputes each once more) and the first step's gradients (on the
    CPU), as ``optim.update`` receives them. The first step pays one-time
    costs (cuBLAS's handles, the kernels' loads), so times are read off the
    last."""
    cfg = moe_dp_cfg()
    params = base.materialize(registry.get_api(cfg).specs(),
                              torch.Generator(device=dev).manual_seed(0), dtype=torch.float32,
                              device=dev)
    opt = optim.init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MOE_DP["seq"],
                                  global_batch=MOE_DP["batch"]))
    shard, n_shards = (0, 1) if mesh is None else (mesh.axis_index("data"), mesh.shape["data"])
    rows = train.data_rows(MOE_DP["batch"], shard, n_shards)
    step = train_step.make_train_step(cfg, optim.AdamWConfig(lr=1e-3), 1, mesh)
    seen, real_update = [], optim.update

    def update(ocfg, p, grads, *a):
        if not seen:
            seen.append({k: v.detach().cpu() for k, v in base.tree_paths(grads).items()})
        return real_update(ocfg, p, grads, *a)

    out = dict(losses=[], grad_norms=[], step_ms=[], gloo_ms=[], flash_launches=[],
               flash_bwd_launches=[], drops=[])
    coll = {}
    optim.update = update
    try:
        with set_mesh(mesh), (timed_collectives(coll) if mesh is not None
                              else contextlib.nullcontext()):
            for i in range(MOE_DP["steps"]):
                batch = {k: torch.from_numpy(v[rows]).to(dev)
                         for k, v in data.batch_at(i).items()}
                drops = []
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with counted_drops(drops):
                    params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["gloo_ms"].append(sum(v["ms"] for v in coll.values()) - sum(out["gloo_ms"]))
                out["flash_launches"].append(flash_attention_fwd.launches)
                out["flash_bwd_launches"].append(flash_attention_bwd.launches)
                out["losses"].append(float(metrics["loss"]))
                out["grad_norms"].append(float(metrics["grad_norm"]))
                out["drops"].append(drops[:MOE_DP["n_layers"]])
    finally:
        optim.update = real_update
    out.update(grads=seen[0], collectives=coll)
    return out


def _moe_dp_rank(rank, world, rendezvous, out_dir):
    """One rank of (h), in a process of its own on the card: a gloo group from
    a file:// rendezvous, the (world, 1) mesh over it, ``moe_dp_steps``, each
    gradient leaf held against the one process's (saved by the parent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", init_method=f"file://{rendezvous}", rank=rank,
                           world_size=world, backend="gloo")
    try:
        res = moe_dp_steps(dev, make_mesh((world, 1), ("data", "model"), dev))
        want = torch.load(out_dir / "one_grads.pt")
        got = res.pop("grads")
        check(got.keys() == want.keys(), "(h) the gradient leaves differ")
        res["grads_of_max"] = {k: float((got[k] - w).abs().max() / w.abs().max())
                               for k, w in want.items()}
        res["backend"] = dist.get_backend()
        torch.save(res, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_moe_dp(dev, smi):
    """(h) granite's MoE training step over two data ranks on the card against
    one process on the whole batch: the first step's loss within
    MOE_DP_TOL["loss"], each gradient leaf within MOE_DP_TOL["grads_of_max"]
    of its largest entry, the grad norms as the loss, assignments dropped
    (the ranks' drops adding up to the one process's). Returns its line and
    the flash launches of the ranks' steps."""
    one = moe_dp_steps(dev)
    dp_dir = PARALLEL_DIR / "moe_dp"
    shutil.rmtree(dp_dir, ignore_errors=True)
    dp_dir.mkdir(parents=True)
    torch.save(one.pop("grads"), dp_dir / "one_grads.pt")
    torch.cuda.empty_cache()
    wall_s = spawn_ranks(_moe_dp_rank, (TP_WORLD, dp_dir / "rendezvous", dp_dir), TP_TIMEOUT_S,
                         "(h)")
    ranks = [torch.load(dp_dir / f"rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]
    shutil.rmtree(dp_dir, ignore_errors=True)
    t = MOE_DP_TOL
    loss_err = abs(ranks[0]["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    norm_err = abs(ranks[0]["grad_norms"][0] - one["grad_norms"][0]) / one["grad_norms"][0]
    grad_err = max(max(r["grads_of_max"].values()) for r in ranks)
    rank_drops = [sum(r["drops"][0][i] for r in ranks) for i in range(MOE_DP["n_layers"])]
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks),
          f"(h) the ranks' losses differ: {[r['losses'] for r in ranks]}")
    check(loss_err <= t["loss"] and norm_err <= t["loss"],
          f"(h) loss {ranks[0]['losses'][0]} vs one process {one['losses'][0]}, grad norm "
          f"{ranks[0]['grad_norms'][0]} vs {one['grad_norms'][0]}")
    check(grad_err <= t["grads_of_max"], f"(h) gradients {grad_err} of a leaf's largest entry")
    check(min(one["drops"][0]) > 0 and rank_drops == one["drops"][0],
          f"(h) dropped assignments: ranks {rank_drops}, one process {one['drops'][0]}")
    per_step = 2 * MOE_DP["n_layers"]  # the forward, and remat's recompute in the backward
    check(all(r["flash_launches"] == [per_step] * MOE_DP["steps"]
              and r["flash_bwd_launches"] == [MOE_DP["n_layers"]] * MOE_DP["steps"]
              for r in (one, *ranks)),
          f"(h) flash launches (forward, backward) "
          f"{[(r['flash_launches'], r['flash_bwd_launches']) for r in (one, *ranks)]}")
    BWD_BY_PATH["parallel_moe_data_parallel"] = sum(sum(r["flash_bwd_launches"]) for r in ranks)
    worst = max(ranks, key=lambda r: max(r["grads_of_max"].values()))["grads_of_max"]
    coll = [r["collectives"] for r in ranks]
    line = dict(
        arch=moe_dp_cfg().arch, n_layers=MOE_DP["n_layers"], dtype="float32",
        capacity_factor=MOE_DP["capacity_factor"], mesh=dict(data=TP_WORLD, model=1),
        backend=ranks[0]["backend"], device="one card, both ranks on cuda:0",
        tokens_per_rank=[MOE_DP["batch"] // TP_WORLD, MOE_DP["seq"]],
        capacity=dict(global_batch=moe.capacity(moe_dp_cfg(), MOE_DP["batch"] * MOE_DP["seq"]),
                      one_rank_alone=moe.capacity(moe_dp_cfg(),
                                                  MOE_DP["batch"] * MOE_DP["seq"] // TP_WORLD)),
        dropped_assignments=dict(one_process=one["drops"][0],
                                 ranks=[r["drops"][0] for r in ranks]),
        losses=dict(one_process=one["losses"], ranks=ranks[0]["losses"]),
        loss_rel_err=loss_err, grad_norm_rel_err=norm_err, grads_max_of_leaf_max=grad_err,
        worst_leaf=max(worst, key=worst.get), tol=t,
        step_ms=dict(one_process=one["step_ms"], ranks=[r["step_ms"] for r in ranks]),
        gloo=[dict(calls={name: v["calls"] for name, v in c.items()}, ms_per_step=r["gloo_ms"],
                   share_of_last_step=r["gloo_ms"][-1] / r["step_ms"][-1])
              for c, r in zip(coll, ranks)],
        flash_launches_per_step=per_step, spawn_to_end_s=wall_s, nvidia_smi=smi,
        note="two ranks share one card and gloo copies every collective through the host: "
             "these times are not data-parallel speed")
    return line, sum(sum(r["flash_launches"]) for r in ranks)


# (g): tensor parallelism of the other families' training steps on the same
# (1, 2) mesh, two processes on the card over gloo as in (f): whisper-medium
# (encdec), deepseek-v3-671b (MLA, with its dense-first layers and MTP),
# xlstm-125m (ssm) and zamba2-2.7b (hybrid). Per arch: the config, (g1)'s cut
# (f32, 2 steps against one process) and its batch x tokens, (g2)'s cut (bf16,
# full widths) and its batch x tokens. deepseek-v3's 256-expert MoE layer does
# not fit beside AdamW's moments: (g2) runs its three dense layers and MTP
# (3.36 B parameters), (g1) one dense layer and MTP; the MoE layers' placement
# with MLA is held on the CPU (tests/test_torch_tensor_parallel_families.py).
# The recurrent families run no remat: (g2) cuts zamba2 to 9 layers (one
# application of the shared block) and both to short sequences (xlstm 1 x 128,
# zamba2 1 x 256; their per-token recurrences are host loops, whose time grows
# with the tokens and shows nothing more at 256 and 512).
TPF = {
    "whisper-medium": (whisper_medium.CONFIG, dict(n_layers=2, n_enc_layers=2), (2, 64), {},
                       (2, 416)),
    "deepseek-v3-671b": (deepseek_v3_671b.CONFIG, dict(n_layers=1, first_k_dense=1), (2, 256),
                         dict(n_layers=3, first_k_dense=3), (1, PROMPT)),
    "xlstm-125m": (xlstm_125m.CONFIG, dict(n_layers=4), (2, 64), {}, (1, 128)),
    "zamba2-2.7b": (zamba2_2_7b.CONFIG, dict(n_layers=10), (2, 64), dict(n_layers=9), (1, 256)),
}
TPF_STEPS = 2  # steps of each (g1) and (g2) run
TPF_TIMEOUT_S = 600
TPF_LR = 1e-3  # launch.train.run's schedule at this lr: warmup 20, cosine over the run


def tpf_cfgs(arch):
    """(g1)'s config (f32) and (g2)'s (the published dtype, bf16) of ``arch``."""
    cfg, cut1, _, cut2, _ = TPF[arch]
    return cfg.with_(**cut1, dtype=torch.float32), cfg.with_(**cut2)


def tpf_batches(cfg, shape, seed):
    """TPF_STEPS batches of ``shape`` (batch, tokens), drawn by numpy as the
    families phase draws them (whisper's 1500 frames too), on the CPU."""
    rng = np.random.default_rng(seed)
    return [family_batch(cfg, rng, *shape, labels=True) for _ in range(TPF_STEPS)]


def train_flash_per_step(cfg, backward=False):
    """Flash forward launches of one training step: each attention layer of
    the forward (``flash_per_forward``), again in the backward with remat, and
    MTP's block once (it runs without remat). With ``backward``, the
    backward's launches: one for each attention of the forward."""
    layers = flash_per_forward(cfg.with_(mtp_depth=0))
    mtp = cfg.mtp_depth if layers else 0
    return layers + mtp if backward else layers * (2 if cfg.remat else 1) + mtp


def tpf_by_hand(dev, cfg, batches, mesh):
    """The steps of ``launch.train.run`` on ``batches``: the parameters drawn
    from a generator seeded 0 in the specs' dtypes, placed by the rules
    (``sharding.shard_params``), AdamW under run's schedule,
    ``make_train_step`` on ``mesh`` under ``set_mesh``. Returns the final
    parameters."""
    params = base.materialize(registry.get_api(cfg).specs(),
                              torch.Generator(device=dev).manual_seed(0), device=dev)
    params = sharding.shard_params(params, cfg, mesh)
    state = optim.init(params)
    step = train_step.make_train_step(
        cfg, optim.AdamWConfig(lr=TPF_LR, warmup=20, total_steps=len(batches)), mesh=mesh)
    with set_mesh(mesh):
        for b in batches:
            params, state, _ = step(params, state, {k: v.to(dev) for k, v in b.items()})
    return params


def tpf_steps(dev, cfg, shape, seed, mesh=None):
    """TPF_STEPS steps of ``launch.train.run(cfg=, mesh=)`` (``mesh`` None:
    one process) on batches of ``shape`` (batch, tokens), an f32 config's
    parameters in f32 (``f32_params``); but whisper's batches carry the
    frames that run's synthetic data does not, so its steps are built as
    run builds them (``tpf_by_hand``) on ``tpf_batches``. Each step is timed
    between two synchronizes with its flash launches, loss and grad norm,
    and on a mesh the host ms inside gloo's all-reduces and all-gathers.
    Returns (params, a record of the run)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    records, bytes_, coll = [], {}, {}
    with (f32_params() if cfg.dtype == torch.float32 else contextlib.nullcontext()), \
            sized_steps(bytes_), recorded_steps(records), \
            (timed_collectives(coll) if mesh is not None else contextlib.nullcontext()):
        reset_counts()
        if cfg.family == "encdec":
            params = tpf_by_hand(dev, cfg, tpf_batches(cfg, shape, seed), mesh)
        else:
            params, _ = train.run(cfg.arch, cfg=cfg, steps=TPF_STEPS, batch=shape[0],
                                  seq=shape[1], lr=TPF_LR, log_every=1, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        n = counts()
    return params, dict(losses=[r["loss"] for r in records],
                        grad_norms=[r["grad_norm"] for r in records],
                        step_ms=[r["ms"] for r in records],
                        flash_launches_per_step=[r["flash_launches"] for r in records],
                        launches=n, bytes=bytes_,
                        max_memory_allocated=torch.cuda.max_memory_allocated(),
                        collectives=coll)


def tpf_one_process(dev, plan_dir):
    """(g1) and (g2) of every TPF arch on one process: (g1)'s final
    parameters saved to ``plan_dir`` for the ranks to compare with, and each
    run's record."""
    out = {}
    for i, arch in enumerate(TPF):
        c1, c2 = tpf_cfgs(arch)
        params, g1 = tpf_steps(dev, c1, TPF[arch][2], 40 + i)
        torch.save({k: v.cpu() for k, v in base.tree_paths(params).items()},
                   plan_dir / f"g1_{i}.pt")
        del params
        params, g2 = tpf_steps(dev, c2, TPF[arch][4], 50 + i)
        del params
        out[arch] = dict(g1=g1, g2=g2)
    torch.cuda.empty_cache()
    return out


def _tpf_rank(rank, world, rendezvous, plan_dir):
    """One rank of (g), in a process of its own on the card: a gloo group
    from a file:// rendezvous, the (1, world) mesh over it; per TPF arch,
    (g1) with this rank's blocks of the final parameters held against the
    one process's (each leaf's block along its split dim, a whole leaf
    whole: together the gathered parameters), then (g2)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", init_method=f"file://{rendezvous}", rank=rank,
                           world_size=world, backend="gloo")
    try:
        mesh = make_mesh((1, world), ("data", "model"), dev)
        r, t = mesh.axis_index("model"), TP_TOL
        out = {}
        for i, arch in enumerate(TPF):
            c1, c2 = tpf_cfgs(arch)
            params, g1 = tpf_steps(dev, c1, TPF[arch][2], 40 + i, mesh)
            want = torch.load(plan_dir / f"g1_{i}.pt", mmap=True)
            worst = {}
            dims = sharding.split_dims(c1, mesh)
            for (k, p), d in zip(base.tree_paths(params).items(), dims):
                w = (want[k] if d is None else want[k].chunk(world, d)[r]).to(dev)
                torch.testing.assert_close(p, w, rtol=t["params_rtol"], atol=t["params_atol"],
                                           msg=lambda m: f"(g1) {arch} {k}: {m}")
                worst[k] = float((p - w).abs().max())
            del params, want, p, w
            g1.update(params_max_abs_err=max(worst.values()),
                      worst_leaf=max(worst, key=worst.get), n_split=sum(d is not None
                                                                        for d in dims))
            params, g2 = tpf_steps(dev, c2, TPF[arch][4], 50 + i, mesh)
            del params  # before the next arch's runs, whose peaks must not hold it
            out[arch] = dict(g1=g1, g2=g2)
        out["backend"] = dist.get_backend()
        torch.save(out, plan_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_tp_families(dev, smi):
    """(g) The training steps of whisper-medium, deepseek-v3-671b, xlstm-125m
    and zamba2-2.7b tensor-parallel over two processes on the card against
    one process, which runs first, each through ``launch.train.run(mesh=)``
    (whisper by hand): (g1) in f32 at cut depth, the losses, each step's
    grad norm and the final parameters within TP_TOL; (g2) in bf16 at full
    widths, the losses within 2e-3, each rank's parameter, gradient and AdamW bytes equal
    to the dry run's per-device bytes on the (1, 2) mesh, its peak beside one
    process's, ms a step, gloo's all-reduces and all-gathers, and the flash
    launches of each step at the rank's heads. Returns the line and the flash
    launches of both ranks' runs."""
    plan_dir = PARALLEL_DIR / "tp_families"
    shutil.rmtree(plan_dir, ignore_errors=True)
    plan_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    one = tpf_one_process(dev, plan_dir)
    one_s = time.perf_counter() - t0
    wall_s = spawn_ranks(_tpf_rank, (TP_WORLD, plan_dir / "rendezvous", plan_dir), TPF_TIMEOUT_S,
                         "(g)")
    ranks = [torch.load(plan_dir / f"rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]
    shutil.rmtree(plan_dir, ignore_errors=True)
    t, mesh = TP_TOL, Mesh(("data", "model"), (1, TP_WORLD))
    lines, launches, bwd_launches = {}, 0, 0
    for arch in TPF:
        c1, c2 = tpf_cfgs(arch)
        o1, o2 = one[arch]["g1"], one[arch]["g2"]
        # (g1): f32, the losses against one process (the parameters were held in the ranks)
        rs1 = [r[arch]["g1"] for r in ranks]
        err1 = max(abs(a - b) / abs(b) for r in rs1 for a, b in zip(r["losses"], o1["losses"]))
        check(all(r["losses"] == rs1[0]["losses"] for r in rs1) and err1 <= t["loss"],
              f"(g1) {arch} losses {[r['losses'] for r in rs1]} vs one process {o1['losses']}")
        norm1 = max(abs(a - b) / abs(b) for r in rs1
                    for a, b in zip(r["grad_norms"], o1["grad_norms"]))
        check(len(o1["grad_norms"]) == TPF_STEPS and norm1 <= t["grad_norm"],
              f"(g1) {arch} grad norms {[r['grad_norms'] for r in rs1]} vs one process "
              f"{o1['grad_norms']}")
        # (g2): bf16, full widths
        rec = dryrun.dry_cell(c2, ShapeConfig("g2", TPF[arch][4][1], TPF[arch][4][0], "train"),
                              mesh, "1x2", counts=dict(flops=0, peak_bytes=0, count_s=0.0))
        per_dev = rec["per_device_bytes"]
        want_flash = train_flash_per_step(c2)
        rank_lines = []
        for i, r in enumerate(ranks):
            g1, g2 = r[arch]["g1"], r[arch]["g2"]
            check(g1["flash_launches_per_step"] == [train_flash_per_step(c1)] * TPF_STEPS,
                  f"(g1) {arch} rank {i} flash launches {g1['flash_launches_per_step']}")
            check(all(math.isfinite(x) for x in g2["losses"]), f"(g2) {arch} rank {i}: {g2}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(g2["losses"], o2["losses"]))
            check(rel <= t["bf16_loss"],
                  f"(g2) {arch} rank {i} losses {g2['losses']} vs {o2['losses']}")
            check(g2["bytes"]["params"] == g2["bytes"]["grads"] == per_dev["params"]
                  and g2["bytes"]["adamw_state"] == per_dev["opt_state"],
                  f"(g2) {arch} rank {i} bytes {g2['bytes']} vs the dry run's {per_dev}")
            check(g2["flash_launches_per_step"] == [want_flash] * TPF_STEPS
                  and g2["launches"]["flash_attention_fwd"] == want_flash * TPF_STEPS
                  and g2["launches"]["flash_attention_bwd"]
                  == train_flash_per_step(c2, backward=True) * TPF_STEPS,
                  f"(g2) {arch} rank {i} flash launches {g2['flash_launches_per_step']}, "
                  f"want {want_flash} a step; {g2['launches']}")
            check(g1["launches"]["flash_attention_bwd"]
                  == train_flash_per_step(c1, backward=True) * TPF_STEPS,
                  f"(g1) {arch} rank {i} backward launches {g1['launches']}")
            launches += (g1["launches"]["flash_attention_fwd"]
                         + g2["launches"]["flash_attention_fwd"])
            bwd_launches += (g1["launches"]["flash_attention_bwd"]
                             + g2["launches"]["flash_attention_bwd"])
            coll = {name: dict(calls=c["calls"], ms=c["ms"], share_of_steps=c["ms"] / sum(
                g2["step_ms"])) for name, c in g2["collectives"].items()}
            rank_lines.append(dict(
                rank=i, g1_losses=g1["losses"], g1_params_max_abs_err=g1["params_max_abs_err"],
                g1_worst_leaf=g1["worst_leaf"], g1_n_split=g1["n_split"],
                losses=g2["losses"], loss_max_rel_err=rel, step_ms=g2["step_ms"],
                flash_launches_per_step=g2["flash_launches_per_step"], launches=g2["launches"],
                bytes=g2["bytes"], bytes_over_one_process={
                    k: v / o2["bytes"][k] for k, v in g2["bytes"].items()},
                max_memory_allocated=g2["max_memory_allocated"],
                peak_over_one_process=g2["max_memory_allocated"] / o2["max_memory_allocated"],
                collectives=coll))
        check(ranks[0][arch]["g2"]["losses"] == ranks[1][arch]["g2"]["losses"],
              f"(g2) {arch}: the ranks' losses differ")
        lines[arch] = dict(
            g1_f32=dict(cut={k: getattr(c1, k) for k in TPF[arch][1]},
                        batch_tokens=list(TPF[arch][2]), steps=TPF_STEPS,
                        entry="by hand" if c1.family == "encdec" else "launch.train.run",
                        one_process_losses=o1["losses"], loss_max_rel_err=err1,
                        one_process_grad_norms=o1["grad_norms"], grad_norm_max_rel_err=norm1,
                        tol=t,
                        flash_launches_per_step=train_flash_per_step(c1)),
            g2_bf16=dict(cut={k: getattr(c2, k) for k in TPF[arch][3]},
                         n_layers=c2.n_layers, n_enc_layers=c2.n_enc_layers,
                         batch_tokens=list(TPF[arch][4]), steps=TPF_STEPS, remat=c2.remat,
                         entry="by hand" if c2.family == "encdec" else "launch.train.run",
                         heads_per_rank=c2.n_heads // TP_WORLD,
                         dry_run_per_device_bytes=per_dev,
                         one_process=dict(losses=o2["losses"], step_ms=o2["step_ms"],
                                          bytes=o2["bytes"],
                                          max_memory_allocated=o2["max_memory_allocated"],
                                          flash_launches_per_step=o2["flash_launches_per_step"]),
                         ranks=rank_lines))
    line = dict(backend=ranks[0]["backend"], world=TP_WORLD, mesh=dict(data=1, model=TP_WORLD),
                device="one card, both ranks on cuda:0", one_process_s=one_s,
                spawn_to_end_s=wall_s, archs=lines,
                note="two ranks share one card and gloo copies every collective through "
                     "the host: these times are not tensor-parallel speed")
    BWD_BY_PATH["parallel_tp_families"] = bwd_launches
    return line, launches


def phase_parallel(dev, cfg, smi):
    """The parallel layer at runtime on the card (see the module docstring,
    phase 16). Returns the launch counts of (b)'s mesh run and the flash
    launches of (f)'s full-depth run over both ranks."""
    # (b) first without a group: mesh=None inside one would build the (1, 1) mesh
    t_phase = time.perf_counter()
    p_one, h_one, r_one, _ = parallel_train(dev, cfg)
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    pdev = init_distributed(dev, init_method=f"file://{PARALLEL_DIR / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), pdev)
        start_s, backend = time.perf_counter() - t0, dist.get_backend()
        p_mesh, h_mesh, r_mesh, n = parallel_train(dev, cfg, mesh)
        per_step = 2 * cfg.n_layers
        check(h_mesh == h_one and all(torch.equal(a, b) for a, b in zip(
            base.tree_leaves(p_mesh), base.tree_leaves(p_one))),
              f"(b) the one-rank mesh run differs from mesh=None: {h_mesh} vs {h_one}")
        check(all(r["flash_launches"] == per_step and r["flash_bwd_launches"] == cfg.n_layers
                  for r in r_mesh)
              and n["flash_attention_fwd"] == per_step * PARALLEL_STEPS
              and n["flash_attention_bwd"] == cfg.n_layers * PARALLEL_STEPS,
              f"(b) flash launches {[r['flash_launches'] for r in r_mesh]}, total {n}")
        BWD_BY_PATH["parallel_train"] = n["flash_attention_bwd"]
        del p_one
        data_mean = parallel_data_mean(dev, cfg, p_mesh, mesh)
        train_line = dict(arch=cfg.arch, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=PARALLEL_STEPS,
                          dtype=str(cfg.dtype).replace("torch.", ""), remat=cfg.remat,
                          losses=[l for _, l in h_mesh], bit_equal=True,
                          flash_launches_per_step=per_step, launches=n,
                          ms_per_step_after_first={
                              name: sum(r["ms"] for r in rs[1:]) / (len(rs) - 1)
                              for name, rs in (("mesh_none", r_one), ("mesh_1x1", r_mesh))},
                          first_step_ms={"mesh_none": r_one[0]["ms"],
                                         "mesh_1x1": r_mesh[0]["ms"]},
                          data_mean_skipped_in_step=True, data_mean=data_mean)
        wall = {"b": time.perf_counter() - t_phase}
        t0 = time.perf_counter()
        compressed = parallel_compressed(dev, p_mesh, cfg, mesh)
        del p_mesh
        torch.cuda.empty_cache()
        wall["d"], t0 = time.perf_counter() - t0, time.perf_counter()
        ep = parallel_ep(dev, mesh)
        wall["c"], t0 = time.perf_counter() - t0, time.perf_counter()
        sweep_line = parallel_sweep()
        wall["e"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    tp_line, tp_launches = parallel_tp(dev, cfg, smi)
    wall["f"], t0 = time.perf_counter() - t0, time.perf_counter()
    tpf_line, tpf_launches = parallel_tp_families(dev, smi)
    wall["g"], t0 = time.perf_counter() - t0, time.perf_counter()
    moe_dp_line, moe_dp_launches = parallel_moe_dp(dev, smi)
    wall["h"] = time.perf_counter() - t0
    emit("parallel", nvidia_smi=smi, backend=backend, world=1, mesh=dict(data=1, model=1),
         group_start_s=start_s, b_train=train_line, c_moe_apply_ep=ep,
         d_compressed_allreduce=compressed, e_sweep_two_entries=sweep_line, f_tp=tp_line,
         g_tp_families=tpf_line, h_moe_data_parallel=moe_dp_line,
         wall_s=dict(wall, phase=time.perf_counter() - t_phase))
    return n, tp_launches, tpf_launches, moe_dp_launches


def _mean_row(rows):
    """One launch, averaged over the tiers timed: its times and its bound."""
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
    bnd, by = bound_ms(mean["bytes"], mean["flops"])
    return dict(ms=mean["ms"], plain_ms=mean["plain_ms"], bound_ms=bnd, bound_by=by)


PHASE_SECONDS: dict = {}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, then one line with the phase's name and wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(json.dumps({"phase_seconds": {"name": name, "s": PHASE_SECONDS[name]}}), flush=True)
    return out


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build, and each kernel against plain at full width only "
                         "(no path, serve, policy, prefill, times, profile, train, moe, mla, "
                         "families, dryrun, ssd, sweep or parallel phase)")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the families phase's frames and tokens")
    a = ap.parse_args()

    smi = timed("device", phase_device)
    dev = torch.device("cuda")
    timed("build", phase_build)
    errs = timed("kernels", lambda: {
        "tiered_decode_partial": check_partial(dev, a.quick),
        "quantize_pages": check_quant(dev, a.quick),
        "flash_attention_fwd": check_flash(dev, a.quick),
        "ordered_scatter_add": check_ordered(dev, a.quick),
        "flash_attention_bwd": check_flash_bwd(dev, a.quick)})
    emit("kernels", max_abs_err=errs)
    if not a.quick:
        cfg = tinyllama_1_1b.CONFIG
        timed("path", phase_path, dev)
        timed("prefill_path", phase_prefill_path, dev)
        timed("syncs", phase_syncs, dev, cfg)
        runs = timed("serve", phase_serve, dev, cfg, STEPS, 4)
        launches = {k: runs[True][k] for k in ("tiered_decode_partial", "quantize_pages")}
        # quantize_pages' main paths: the RARO serve run and the controller's cases
        store_by_path = {"serve_raro": launches["quantize_pages"],
                         "policy": timed("policy", phase_policy, dev, cfg)["quantize_pages"]}
        launches["quantize_pages"] = sum(store_by_path.values())
        prefill_launches = timed("prefill", phase_prefill, dev, cfg)["flash_attention_fwd"]
        # before the profiler, whose cost outlasts its window
        times = timed("times", phase_times, dev)
        timed("profile", phase_profile, dev, cfg)
        timed("profile_prefill", phase_profile_prefill, dev, cfg)
        train_launches, train_attention = timed("train", phase_train, dev, cfg, smi)
        moe_launches = timed("moe", phase_moe, dev, smi)
        mla_launches, mla_entry = timed("mla", phase_mla, dev, smi)
        family_launches, whisper_entry = timed("families", phase_families, dev, smi, a.seed)
        dryrun_launches = timed("dryrun", phase_dryrun, dev, smi)
        # ordered_scatter_add's main path: the simulator's obs sums in the ssd phase
        reset_counts()
        _, ssd_states = timed("ssd", phase_ssd, dev)
        launches["ordered_scatter_add"] = counts()["ordered_scatter_add"]
        timed("sweep", phase_sweep, dev, *ssd_states["b_raro_lattice_openloop_50k"])
        parallel_launches, tp_launches, tpf_launches, moe_dp_launches = timed(
            "parallel", phase_parallel, dev, cfg, smi)
        # flash attention's main paths: tinyllama's prefill (f32) and training
        # (bf16), granite's prefill and training (bf16), deepseek-v3's MLA
        # prefill (bf16), whisper's prefill (bf16: encoder, decoder and cross)
        # and training step (f32, 2 + 2 layers), the dry run's cells (bf16),
        # tinyllama's training on the one-rank mesh (bf16), and on the (1, 2)
        # mesh, tensor-parallel, both ranks' launches (bf16); whisper's and
        # deepseek-v3's training there, both ranks' launches (f32 and bf16);
        # and granite's MoE step over two data ranks, both ranks' launches (f32)
        by_path = {"prefill": prefill_launches, "train": train_launches["flash_attention_fwd"],
                   **moe_launches, "mla_prefill": mla_launches,
                   "whisper_prefill": family_launches["whisper-medium"],
                   "whisper_train": family_launches["whisper_train"],
                   "dryrun_cells": dryrun_launches["flash_attention_fwd"],
                   "parallel_train": parallel_launches["flash_attention_fwd"],
                   "parallel_tp": tp_launches, "parallel_tp_families": tpf_launches,
                   "parallel_moe_data_parallel": moe_dp_launches}
        launches["flash_attention_fwd"] = sum(by_path.values())
        flash_err = errs["flash_attention_fwd"]
        errs["flash_attention_fwd"] = max(flash_err.values())
        # the backward's main paths: every training step on the card above
        # (tinyllama's, granite's, whisper's, the dry run's train cells, the
        # one-rank mesh's, and both ranks' of (f2), (g) and (h))
        launches["flash_attention_bwd"] = sum(BWD_BY_PATH.values())
        bwd_err = errs["flash_attention_bwd"]
        errs["flash_attention_bwd"] = max(bwd_err.values())
        times["flash_attention_bwd"] = train_attention["bwd_times"]
        extra = {"quantize_pages": dict(launches_by_path=store_by_path),
                 "ordered_scatter_add": dict(
                     launches_by_path={"ssd": launches["ordered_scatter_add"]},
                     launches_per_chunk={"full": 2, "counters": 1, "off": 0},
                     library="torch.index_add on CUDA (atomic adds, no fixed order)"),
                 "flash_attention_fwd": dict(
            launches_by_path=by_path, train_bf16=dict(**train_attention["times"], max_abs_err={
                dt: train_attention[dt]["max_abs_err"] for dt in ("float32", "bfloat16")}),
            granite_bf16=dict(**times["flash_granite"], max_abs_err={
                dt: flash_err[f"granite_{dt}"] for dt in ("float32", "bfloat16")}),
            mla_bf16=dict(**times["flash_mla"], max_abs_err={
                dt: flash_err[f"mla_{dt}"] for dt in ("float32", "bfloat16")},
                autograd_entry_max_abs_err={dt: r["max_abs_err"] for dt, r in mla_entry.items()}),
            **{f"{label}_bf16": dict(**times[f"flash_{label}"], max_abs_err={
                dt: flash_err[f"{label}_{dt}"] for dt in ("float32", "bfloat16")})
               for label in (*WHISPER_FLASH, *FLASH_TP_FAMILIES)},
            whisper_autograd_entry_max_abs_err={
                label: {dt: r["max_abs_err"] for dt, r in e.items()}
                for label, e in whisper_entry.items()}),
                 "flash_attention_bwd": dict(
            launches_by_path=BWD_BY_PATH, max_abs_err_by_dtype=bwd_err,
            shape=list(FLASH_FULL), dtype="bfloat16",
            library="the backward of torch.nn.functional.scaled_dot_product_attention",
            forward_with_lse_ms=train_attention["times"]["lse_ms"],
            entry_backward_ms=train_attention["bwd_times"]["entry_backward_ms"])}
        print(json.dumps({"kernels": [
            dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errs[k],
                 ms=times[k]["ms"], plain_ms=times[k]["plain_ms"], bound_ms=times[k]["bound_ms"],
                 bound_by=times[k]["bound_by"], library_ms=times[k].get("library_ms"),
                 **extra.get(k, {}))
            for k in KERNELS]}), flush=True)
        check(all(launches[k] > 0 for k in KERNELS), f"a kernel was never launched: {launches}")
    print(json.dumps({"phase_seconds_total": dict(PHASE_SECONDS,
                                                  total_s=time.perf_counter() - t_start)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
