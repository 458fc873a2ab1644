"""One run of one cell: find its pieces by name, set up, measure, check.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``cardbench/configs/<config>.json``: the configuration as it is run
  (the ``file`` of its entry);
* ``cardbench/traffic/<traffic>.json``: the mix's parameters, whose
  ``runner`` names the module of ``cardbench/runners/`` that runs it;
* ``cardbench/checks/<workload>.json``: the limit of each number that
  decides ``correct``;
* ``cardbench/metrics/<metric>.py``: a reader whose ``read(reading)``
  returns the metric from a traced window, or None where it finds nothing.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from cardbench import tracing

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cardbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, workload=w, config=load_json(root / centry["file"]),
                traffic=load_json(root / "cardbench" / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / "cardbench" / "checks" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def runner(traffic: dict):
    return importlib.import_module(f"cardbench.runners.{traffic['runner']}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("cardbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# the configuration as the program takes it
# --------------------------------------------------------------------------
def port_config(c: dict):
    """The program's ModelConfig for configuration ``c``; raises where the
    file states something the program cannot run as written."""
    from repro_torch.configs.base import ModelConfig

    d, h = c["hidden_size"], c["num_attention_heads"]
    dh = d // h
    need = {"hidden_act": "silu", "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
            "attention_bias": False, "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
            "logits_scaling": 1.0, "attention_multiplier": dh ** -0.5}
    for key, want in need.items():
        if key in c and c[key] != want:
            raise ValueError(f"{c['name']}: {key} = {c[key]!r}; the program runs {want!r}")
    port = c["port"]
    moe = c.get("num_local_experts", 0) > 0
    kw = dict(arch=c["name"], family="moe" if moe else "dense", n_layers=c["num_hidden_layers"],
              d_model=d, n_heads=h, n_kv_heads=c["num_key_value_heads"],
              d_ff=0 if moe else c["intermediate_size"], vocab=c["vocab_size"], d_head=dh,
              rope_theta=float(c["rope_theta"]), dtype=getattr(torch, port["param_dtype"]),
              remat=port["remat"])
    if moe:
        kw.update(n_experts=c["num_local_experts"], top_k=c["num_experts_per_tok"],
                  moe_d_ff=c["intermediate_size"], capacity_factor=port["capacity_factor"],
                  aux_loss_coef=c["router_aux_loss_coef"])
    return ModelConfig(**kw)


def program_specs(cfg) -> dict:
    """{dotted path: ParamSpec} of the program's parameters."""
    from repro_torch.models import base, registry

    return base.tree_paths(registry.get_api(cfg).specs())


def program_params(cfg, tensors: dict, param_dtype: str = "bfloat16"):
    """The program's parameter tree, its leaves the benchmark's tensors by
    name; raises unless every name, shape and dtype agrees. The specs' own
    dtypes are bf16 (the router f32); another ``param_dtype`` puts every
    leaf in that dtype, as the program's ``base.materialize(dtype=)`` does."""
    from repro_torch.models import base, registry

    override = None if param_dtype == "bfloat16" else getattr(torch, param_dtype)
    specs = registry.get_api(cfg).specs()
    paths = base.tree_paths(specs)
    if set(paths) != set(tensors):
        raise ValueError(f"parameter names differ: program only {sorted(set(paths) - set(tensors))[:4]}"
                         f", benchmark only {sorted(set(tensors) - set(paths))[:4]}")
    for p, s in paths.items():
        t = tensors[p]
        if tuple(t.shape) != tuple(s.shape) or t.dtype != (override or s.dtype):
            raise ValueError(f"{p}: program {tuple(s.shape)} {s.dtype}, benchmark "
                             f"{tuple(t.shape)} {t.dtype}")
    return base.tree_unflatten(specs, [tensors[p] for p in paths])


def table_rows(cfg) -> int:
    return program_specs(cfg)["embed.table"].shape[0]


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------
@dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    trace: bool
    fault: str = ""  # a planted fault (tests and calibration only)
    marks: dict = field(default_factory=dict)  # set-up's steps, seconds from the start

    def mark(self, name: str, t_start: float):
        self.marks[name] = time.perf_counter() - t_start


@dataclass
class Window:
    units: int  # steps or requests completed
    seconds: float
    end_to_end: dict  # metric name -> value
    failed: int = 0
    lengths: list = field(default_factory=list)  # each request's prompt length


@dataclass
class Reading:
    """What a per-layer metric reads: the traced window and the cell."""
    runner: str
    config: dict
    traffic: dict
    window: Window
    profile: tracing.Profile
    port_kernels: set


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or under it, and
    only if finite)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = float(numbers[name])
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks


def run(cell_: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: str = "") -> dict:
    """One run: set-up, the window (traced or not), the check. Returns the
    result line's object."""
    device = torch.device(device)
    ctx = Context(cell_, seed, device, trace, fault)
    ctx.mark("imports", t_start)
    drv = runner(cell_.traffic)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context and the allocator up, then the peak from here
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(ctx, lambda name: ctx.mark(name, t_start))
    setup_s = time.perf_counter() - t_start
    if trace:
        win, prof = tracing.traced(lambda: drv.window(ctx, state, seconds, traced=True), device)
    else:
        win, prof = drv.window(ctx, state, seconds, traced=False), None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_window = time.perf_counter()
    kept = drv.keep(ctx, state, win)
    del state
    free(device)
    numbers = drv.check(ctx, kept)
    t_check = time.perf_counter()
    ok, checks = judge(numbers, cell_.limits["limits"])

    metrics = {}
    if trace:
        reading = Reading(cell_.traffic["runner"], cell_.config, cell_.traffic, win, prof,
                          tracing.port_kernels())
        for m in cell_.per_layer:
            if cell_.applies(m):
                v = metric_reader(m["name"])(reading)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(win.end_to_end, setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        for m in cell_.end_to_end:
            if cell_.applies(m):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": win.units, "failed": win.failed, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = prof.busy_s()
        dev["window_s"] = prof.window[1] - prof.window[0]
        out["breakdown"] = {"device_ops": tracing.top(prof.device_s_by_name()),
                            "idle_gaps": tracing.top(prof.idle_by_host())}
    # the process's phases on the host clock (not metrics), then the checks, last
    out["phase_seconds"] = {"setup": setup_s, "window_and_trace": t_window - t_start - setup_s,
                            "check": t_check - t_window, "setup_marks": ctx.marks}
    out["checks"] = checks
    return out
