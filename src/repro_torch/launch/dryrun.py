"""Shape-and-memory dry run on the meta device (counterpart of
``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell: the parameters, the
AdamW state and the inputs as meta tensors (no allocation), their bytes per
device from the sharding rules (each leaf's shard shape from its partition
spec), and one step (``make_train_step``, ``make_prefill`` or
``make_serve_step``) run on the meta device:

  * its FLOPs by ``torch.utils.flop_counter.FlopCounterMode``, the flash
    kernel counted by its own shapes (``flash_flops``) as on the card, and a
    recurrence by its first step and its other T - 1 batched into one
    (``batched_scan``, which stands in for ``ssm._scan`` while a step is
    counted): the same count as T steps;
  * its peak of live tensor bytes (``LiveBytes``), the estimate of the
    card's ``max_memory_allocated``; on the 1x1 card mesh, against the
    card's memory, whether the cell fits.

Meshes: the reference's 16x16 and 2x16x16 (abstract, ``launch/mesh.py``)
and ``h100_1x1``, the one card the port runs on. Records go to
``results/dryrun_torch/<mesh>/<arch>__<shape>.json`` in the reference's
layout. Keys the port cannot compute stay ``null`` and are named in the
record's ``not_computed``: XLA's lower and compile times, its output and
generated-code sizes and the post-partitioning collective table (the
reference's ``parse_collectives`` reads XLA HLO text, which has no
counterpart here); on the production meshes also the per-device FLOPs and
temporaries, since the meta step runs the global shapes on one device.
``input_bytes_global`` is the bytes of ``registry.input_specs`` (the
reference's ``lower_cell`` records ``args[1]`` or ``args[-2]`` under that
name: the optimizer state, the parameters or the tokens; ROADMAP.md).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|card|all] [--variant V,...] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import base, registry, ssm
from repro_torch.parallel import sharding
from repro_torch.serving import serve_step as ss
from repro_torch.training import optim
from repro_torch.training import train_step as ts

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
CARD_MESH = "h100_1x1"
NOMINAL_CARD_BYTES = 80 * 10**9  # an H100's 80 GB, where no card is present
# kept free of the estimate on the card: the CUDA context, cuBLAS's
# workspaces and the caching allocator's rounding and free blocks
CARD_HEADROOM_BYTES = 2 * 2**30
NOT_COMPUTED = ["lower_s", "compile_s", "collectives",
                "memory_analysis.output_size_in_bytes",
                "memory_analysis.generated_code_size_in_bytes"]
# the meta step runs the global shapes on one device, so on a mesh of many
# devices it gives no per-device count
NOT_COMPUTED_SHARDED = ["cost_analysis", "memory_analysis.temp_size_in_bytes"]

MESHES = {
    "single": ("single_pod_16x16", lambda: make_production_mesh(multi_pod=False)),
    "multi": ("multi_pod_2x16x16", lambda: make_production_mesh(multi_pod=True)),
    "card": (CARD_MESH, lambda: make_host_mesh("meta")),
}


def inside_bytes(func, args) -> int:
    """Bytes a kernel allocates inside, beyond its output, while it runs: no
    dispatch mode sees them. On the card (``torch.cuda.memory._snapshot``
    of a training step) these were the gap between the tracked peak and
    ``max_memory_allocated``: softmax copies a non-contiguous input, and its
    backward makes the gradient's product with the output and copies a
    non-contiguous gradient, each as large as its input (the plain
    attention's f32 scores, where a window keeps it). The flash backward's
    wrapper allocates Delta, B·H·Sq f32, inside its operator."""
    def nbytes(t):
        return t.numel() * t.element_size()

    if func is torch.ops.repro_torch.flash_attention_bwd.default:
        return nbytes(args[4])  # Delta, as large as the log-sum-exp
    if func is torch.ops.aten._softmax.default:
        return 0 if args[0].is_contiguous() else nbytes(args[0])
    if func is torch.ops.aten._softmax_backward_data.default:
        return nbytes(args[0]) * (1 if args[0].is_contiguous() else 2)
    return 0


# how many loop steps each tensor made now stands for: T - 1 inside
# ``batched_scan``'s tail where autograd does not record it, else 1
_steps_in_one = 1


def batched_scan(step, carry, xs):
    """``ssm._scan`` on the meta device, for the count: step 0 alone, then
    steps 1..T-1 as one step over a leading time dim, from step 0's carry
    expanded along it. Every product of a step broadcasts over its leading
    dims, so ``FlopCounterMode`` counts exactly the T steps' operations,
    forward and backward (steps 1..T-1 take gradients through their carry,
    step 0 not, as in the loop), from two steps' dispatches instead of T.
    The loop holds one step's temporaries at a time where autograd keeps
    none, so there the tail's tensors count 1/(T - 1) of their bytes
    (``LiveBytes``)."""
    global _steps_in_one
    n_steps = xs[0].shape[0]
    carry, y0 = step(carry, tuple(x[0] for x in xs))
    if n_steps == 1:
        return carry, y0.unsqueeze(1)
    taped = torch.is_grad_enabled() and any(t.requires_grad for t in (*carry, *xs))
    _steps_in_one = 1 if taped else n_steps - 1
    try:
        rest, ys = step(tuple(c.expand(n_steps - 1, *c.shape) for c in carry),
                        tuple(x[1:] for x in xs))
    finally:
        _steps_in_one = 1
    return (tuple(c[-1].clone() for c in rest),
            torch.cat([y0.unsqueeze(1), ys.movedim(0, 1)], dim=1))


@contextlib.contextmanager
def batched_recurrences():
    """``batched_scan`` in place of ``ssm._scan`` while the block runs."""
    plain, ssm._scan = ssm._scan, batched_scan
    try:
        yield
    finally:
        ssm._scan = plain


class LiveBytes(TorchDispatchMode):
    """Bytes of live tensor storage, and their peak, over what runs under
    it: each storage is counted when an operator first returns it (or
    ``track`` is given it) and uncounted when it is freed; what a kernel
    allocates inside (``inside_bytes``) adds to the peak while it runs. A tensor
    made in ``batched_scan``'s tail that autograd does not record counts
    1/(T - 1) of its bytes: the loop it stands for holds one step's
    temporaries at a time."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, tree):
        for t in base.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def _add(self, t):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes() // _steps_in_one
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live + inside_bytes(func, args))
        return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in base.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def shard_bytes(tree, shardings) -> int:
    """Bytes on one device: each leaf's shard shape from its sharding."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in zip(base.tree_leaves(tree), base.tree_leaves(shardings)))


VARIANTS = ("seq_shard", "xent_chunk", "moe_hints", "kv8", "kv4")


def _chunk_for(txt_len: int) -> int:
    for c in (2048, 1920, 1536, 1280, 1024, 960, 768, 640, 512, 384, 256, 128):
        if txt_len % c == 0:
            return c
    return 0


def apply_variants(cfg: ModelConfig, shape: ShapeConfig, variants: tuple[str, ...]):
    """Perf knobs -> config overrides (recorded per cell)."""
    ov = {}
    seq_shard = "seq_shard" in variants
    if "xent_chunk" in variants and shape.kind == "train":
        n_txt = shape.seq_len - (cfg.n_img_tokens if cfg.family == "vlm" else 0)
        c = _chunk_for(n_txt)
        if c:
            ov["xent_chunk"] = c
    if "moe_hints" in variants and cfg.n_experts:
        ov["moe_hints"] = True
    if "kv8" in variants and cfg.family in ("dense", "vlm") and shape.kind == "decode":
        ov["kv_bits"] = 8
    if "kv4" in variants and cfg.family in ("dense", "vlm") and shape.kind == "decode":
        ov["kv_bits"] = 4
    return cfg.with_(**ov) if ov else cfg, ov, seq_shard


def abstract_args(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's arguments on the meta device: {"params", "opt_state"
    (training only, else None), "inputs"}."""
    specs = registry.get_api(cfg).specs()
    opt = base.abstract(optim.opt_state_specs(specs)) if shape.kind == "train" else None
    return {"params": base.abstract(specs), "opt_state": opt,
            "inputs": registry.input_specs(cfg, shape)}


def run_step(cfg: ModelConfig, shape: ShapeConfig, args: dict):
    """One step of the cell's kind on ``args`` (as ``abstract_args`` lays
    them out, on any device): a training step (which updates the parameters
    and moments in place), a prefill, or one decode step."""
    p, inputs = args["params"], args["inputs"]
    if shape.kind == "train":
        return ts.make_train_step(cfg, optim.AdamWConfig())(p, args["opt_state"], inputs)
    if shape.kind == "prefill":
        return ss.make_prefill(cfg)(p, inputs)
    return ss.make_serve_step(cfg)(p, inputs["cache"], inputs["tokens"], inputs["pos"])


def count_step(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One step on the meta device: its FLOPs, the peak of live tensor bytes
    (arguments included) and the seconds the count took."""
    t0 = time.perf_counter()
    args = abstract_args(cfg, shape)
    live = LiveBytes()
    live.track(args)
    with FlopCounterMode(display=False) as flops, live, batched_recurrences():
        run_step(cfg, shape, args)
    return {"flops": int(flops.get_total_flops()), "peak_bytes": live.peak,
            "count_s": time.perf_counter() - t0}


def card_bytes() -> tuple[int, str]:
    """The card's memory and name, or an H100's nominal 80 GB without one."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return NOMINAL_CARD_BYTES, "no card: an H100's nominal 80 GB"


def dry_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_name: str, *,
             variants: tuple[str, ...] = (), overrides=None, seq_shard: bool = False,
             counts: dict | None = None) -> dict:
    """The record of one cell of ``cfg`` (variants applied) at ``shape`` on
    ``mesh``. ``counts`` is ``count_step``'s result for (cfg, shape), which
    does not depend on the mesh; it is computed when not given."""
    args = abstract_args(cfg, shape)
    specs = registry.get_api(cfg).specs()
    inputs = args["inputs"]
    per_device = {"params": shard_bytes(args["params"],
                                        sharding.param_shardings(cfg, specs, mesh))}
    if shape.kind == "train":
        o_shard = base.param_shardings(optim.opt_state_specs(specs), mesh,
                                       sharding.make_rules(cfg, mesh))
        per_device["opt_state"] = shard_bytes(args["opt_state"], o_shard)
    else:
        per_device["opt_state"] = 0
    if shape.kind == "decode":
        c_shard = sharding.cache_shardings(cfg, inputs["cache"], mesh, seq_shard=seq_shard)
        tok = {"tokens": inputs["tokens"], "pos": inputs["pos"]}
        per_device["inputs"] = (shard_bytes(inputs["cache"], c_shard)
                                + shard_bytes(tok, sharding.batch_shardings(cfg, tok, mesh)))
    else:
        per_device["inputs"] = shard_bytes(inputs, sharding.batch_shardings(cfg, inputs, mesh))
    per_device["arguments"] = sum(per_device.values())

    counts = counts or count_step(cfg, shape)
    one_device = mesh.size == 1
    peak = counts["peak_bytes"] if one_device else None
    not_computed = NOT_COMPUTED + ([] if one_device else NOT_COMPUTED_SHARDED)
    fit = None
    if mesh_name == CARD_MESH:
        total, name = card_bytes()
        fit = {"device": name, "device_bytes": total, "headroom_bytes": CARD_HEADROOM_BYTES,
               "peak_bytes": peak, "params_fit": per_device["params"] <= total,
               "fits": peak + CARD_HEADROOM_BYTES <= total}
    return {
        "arch": cfg.arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "variants": list(variants),
        "overrides": dict(overrides or {}),
        "seq_shard": seq_shard,
        "devices": mesh.size,
        "n_layers": cfg.n_layers,
        "family": cfg.family,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "param_bytes_global": tree_bytes(args["params"]),
        "input_bytes_global": tree_bytes(inputs),
        "per_device_bytes": per_device,
        "lower_s": None,
        "compile_s": None,
        "memory_analysis": {
            "argument_size_in_bytes": per_device["arguments"],
            "output_size_in_bytes": None,
            "temp_size_in_bytes": peak - per_device["arguments"] if one_device else None,
            "generated_code_size_in_bytes": None,
        },
        "cost_analysis": {"flops": counts["flops"]} if one_device else None,
        "step_flops_global": counts["flops"],
        "peak_bytes_estimate": peak,
        "fit": fit,
        "collectives": None,
        "not_computed": not_computed,
        "count_s": round(counts["count_s"], 2),
        "status": "ok",
    }


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               variants: tuple[str, ...] = (), counts: dict | None = None) -> dict:
    """The reference's entry: one cell of the ``ARCHS`` x ``SHAPES`` matrix."""
    shape = SHAPES[shape_name]
    cfg, overrides, seq_shard = apply_variants(ARCHS[arch], shape, variants)
    return dry_cell(cfg, shape, mesh, mesh_name, variants=variants, overrides=overrides,
                    seq_shard=seq_shard, counts=counts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="all", choices=["single", "multi", "card", "all"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", help="comma list of perf knobs: "
                    "seq_shard,xent_chunk,moe_hints,kv8,kv4")
    args = ap.parse_args(argv)
    variants = tuple(v for v in args.variant.split(",") if v)
    meshes = [MESHES[m] for m in (MESHES if args.mesh == "all" else (args.mesh,))]
    suffix = ("__" + "_".join(variants)) if variants else ""

    n_ok = n_skip = n_fail = 0
    for arch, cfg0 in ARCHS.items():
        if args.arch and arch != args.arch:
            continue
        for shape_name, shape in SHAPES.items():
            if args.shape and shape_name != args.shape:
                continue
            ok, why = applicable(cfg0.family, shape)
            counts = None  # one meta step serves every mesh of the cell
            for mesh_name, make in meshes:
                outdir = RESULTS / (mesh_name + suffix)
                outdir.mkdir(parents=True, exist_ok=True)
                out = outdir / f"{arch}__{shape_name}.json"
                if not ok:
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                         "status": "skipped", "reason": why}, indent=1))
                    n_skip += 1
                    print(f"[skip] {mesh_name} {arch} {shape_name}: {why}", flush=True)
                    continue
                if out.exists() and not args.force:
                    if json.loads(out.read_text()).get("status") == "ok":
                        n_ok += 1
                        print(f"[cached] {mesh_name} {arch} {shape_name}", flush=True)
                        continue
                t0 = time.time()
                try:
                    if counts is None:
                        cfg = apply_variants(cfg0, shape, variants)[0]
                        counts = count_step(cfg, shape)
                    rec = lower_cell(arch, shape_name, make(), mesh_name, variants, counts)
                    n_ok += 1
                    fit = rec["fit"]
                    print(f"[ok] {mesh_name} {arch} {shape_name} "
                          f"args/device={rec['per_device_bytes']['arguments'] / 1e9:.2f}GB "
                          f"flops={rec['step_flops_global']:.4e}"
                          + (f" peak={fit['peak_bytes'] / 1e9:.2f}GB fits={fit['fits']}"
                             if fit else ""), flush=True)
                except Exception as e:  # a failed cell is recorded; the others go on
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "fail", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:],
                           "elapsed_s": round(time.time() - t0, 1)}
                    n_fail += 1
                    print(f"[FAIL] {mesh_name} {arch} {shape_name}: {type(e).__name__}: {e}",
                          flush=True)
                out.write_text(json.dumps(rec, indent=1))
    print(f"dry-run done: ok={n_ok} skipped={n_skip} failed={n_fail}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
