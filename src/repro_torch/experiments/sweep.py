"""Sweep orchestration (DESIGN.md §7.3): a (policy x wear x seed x knob)
grid through the simulator, from the grid to per-run result dicts and
``BENCH_*.json`` artifacts.

Counterpart of ``repro.experiments.sweep``. The reference batches each
policy group's runs along a stacked run axis (``jax.vmap`` on one device,
``shard_map`` across several); here each run of a group runs in turn on one
device: ``state.init_state`` seeded from the run's knobs, then
``engine.step_chunk`` over the trace's chunks with those knobs, then
``engine.summarize``. The split of the axes is the reference's:

  per run (``RunKnobs``, 0-dim tensors on the run's device):
      seeds / scenario draws, ``r1``, ``r2_override``, ``initial_pe``,
      ``arrival_scale``, the fault axes and ``gc_objective``
  per group (change trace shapes or code paths):
      policy, geometry/SimConfig, scenario name, request count

A knob field is ``None`` exactly where the reference's stacked one is, so
each run takes the code path its reference run takes. The results carry the
same keys and the same ``"run"`` metadata as the reference's, and the
per-group checkpoints, the retries with backoff and the artifacts are the
reference's too.
"""

from __future__ import annotations

import itertools
import json
import time
import warnings
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from repro_torch import ops, resolve_device
from repro_torch.core import modes, reclaim
from repro_torch.experiments import registry
from repro_torch.ssdsim import engine, geometry, metrics_schema, policies
from repro_torch.ssdsim import state as st


@dataclass(frozen=True)
class SweepSpec:
    """A full experiment grid (cross product of every axis)."""

    scenario: str = "zipf"
    n_requests: int = 20_000
    policies: tuple[int, ...] = (geometry.BASELINE, geometry.RARO)
    initial_pe: tuple[int, ...] = (166, 833)
    seeds: tuple[int, ...] = (0, 1)
    r1: tuple[int, ...] = (1,)
    r2_override: tuple[int, ...] = (-1,)
    # offered-load multipliers for open-loop scenarios (traces carrying
    # arrival_ms): effective arrival time = trace arrival / scale. Ignored
    # (with a warning) for closed-loop scenarios.
    arrival_scale: tuple[float, ...] = (1.0,)
    # fault-injection axes (DESIGN.md §2D): while every axis sits at its
    # fault-free default the knob fields stay None and no fault op runs;
    # any non-default value arms them for the whole grid (a rate of exactly
    # 0.0 stays bit-identical to the fault-free run, so mixed grids are safe)
    prog_fail_rate: tuple[float, ...] = (0.0,)
    erase_fail_rate: tuple[float, ...] = (0.0,)
    max_read_retries: tuple[int, ...] = (-1,)
    fault_seed: tuple[int, ...] = (0,)
    # wear-coupled reliability axes (DESIGN.md §2D): ride the fault-knob
    # activation above; their defaults (rate 0.0, slope 0.0, rebuild off,
    # unbounded spares) are bit-identical to the flat-rate run
    read_fail_rate: tuple[float, ...] = (0.0,)
    fault_wear_slope: tuple[float, ...] = (0.0,)
    parity_rebuild: tuple[bool, ...] = (False,)
    spare_blocks: tuple[int, ...] = (-1,)
    # GC victim-objective axis (DESIGN.md §2E) as RunKnobs.gc_objective
    # integer codes: while the axis sits at its default the knob stays None;
    # code 0 (min_valid) is bit-identical to the knob-free run
    gc_objective: tuple[str, ...] = ("min_valid",)
    # forwarded to the scenario builder (e.g. {"theta": 1.2}); tuple-of-items
    # so the spec stays hashable
    scenario_kw: tuple[tuple[str, object], ...] = ()
    base: geometry.SimConfig = field(default_factory=geometry.SimConfig)

    def n_runs(self) -> int:
        return (len(self.policies) * len(self.initial_pe) * len(self.seeds)
                * len(self.r1) * len(self.r2_override)
                * len(self.arrival_scale) * len(self.prog_fail_rate)
                * len(self.erase_fail_rate) * len(self.max_read_retries)
                * len(self.fault_seed) * len(self.read_fail_rate)
                * len(self.fault_wear_slope) * len(self.parity_rebuild)
                * len(self.spare_blocks) * len(self.gc_objective))

    def faults_on(self) -> bool:
        """Any fault axis off its fault-free default -> every run carries
        fault knobs (see ``faults.params_for``)."""
        return (self.prog_fail_rate != (0.0,)
                or self.erase_fail_rate != (0.0,)
                or self.max_read_retries != (-1,)
                or self.fault_seed != (0,)
                or self.read_fail_rate != (0.0,)
                or self.fault_wear_slope != (0.0,)
                or self.parity_rebuild != (False,)
                or self.spare_blocks != (-1,))


@dataclass(frozen=True)
class RunSpec:
    """One point of the grid."""

    scenario: str
    policy: int
    initial_pe: int
    seed: int
    r1: int
    r2_override: int
    arrival_scale: float = 1.0
    prog_fail_rate: float = 0.0
    erase_fail_rate: float = 0.0
    max_read_retries: int = -1
    fault_seed: int = 0
    read_fail_rate: float = 0.0
    fault_wear_slope: float = 0.0
    parity_rebuild: bool = False
    spare_blocks: int = -1
    gc_objective: str = "min_valid"

    def tag(self) -> str:
        parts = [
            self.scenario,
            geometry.POLICY_NAMES[self.policy],
            f"pe{self.initial_pe}",
            f"seed{self.seed}",
        ]
        if self.r1 != 1:
            parts.append(f"r1_{self.r1}")
        if self.r2_override >= 0:
            parts.append(f"r2_{self.r2_override}")
        if self.arrival_scale != 1.0:
            parts.append(f"load{self.arrival_scale:g}")
        if self.prog_fail_rate != 0.0:
            parts.append(f"pfail{self.prog_fail_rate:g}")
        if self.erase_fail_rate != 0.0:
            parts.append(f"efail{self.erase_fail_rate:g}")
        if self.max_read_retries >= 0:
            parts.append(f"mrr{self.max_read_retries}")
        if self.fault_seed != 0:
            parts.append(f"fseed{self.fault_seed}")
        if self.read_fail_rate != 0.0:
            parts.append(f"rfail{self.read_fail_rate:g}")
        if self.fault_wear_slope != 0.0:
            parts.append(f"wear{self.fault_wear_slope:g}")
        if self.parity_rebuild:
            parts.append("parity")
        if self.spare_blocks >= 0:
            parts.append(f"spares{self.spare_blocks}")
        if self.gc_objective != "min_valid":
            parts.append(f"gc_{self.gc_objective}")
        return "_".join(parts)


def expand(spec: SweepSpec) -> list[RunSpec]:
    return [
        RunSpec(spec.scenario, pol, pe, seed, r1, r2, scale, pf, ef, mrr, fs,
                rf, ws, pr, sb, gco)
        for pol, pe, seed, r1, r2, scale, pf, ef, mrr, fs, rf, ws, pr, sb, gco
        in itertools.product(
            spec.policies, spec.initial_pe, spec.seeds, spec.r1,
            spec.r2_override, spec.arrival_scale, spec.prog_fail_rate,
            spec.erase_fail_rate, spec.max_read_retries, spec.fault_seed,
            spec.read_fail_rate, spec.fault_wear_slope, spec.parity_rebuild,
            spec.spare_blocks, spec.gc_objective
        )
    ]


def run_knobs(r: RunSpec, spec: SweepSpec, open_loop: bool, device) -> policies.RunKnobs:
    """One run's knobs as 0-dim tensors on ``device``, with the reference's
    stacked dtypes; a field is ``None`` exactly where the reference's is:
    ``arrival_scale`` only in open loop, the fault fields only when
    ``spec.faults_on()``, ``gc_objective`` only off its default."""
    i32, f32 = torch.int32, torch.float32
    faults_on = spec.faults_on()

    def k(value, dtype, on=True):
        return ops.scalar(value, dtype, device) if on else None

    return policies.RunKnobs(
        r1=k(r.r1, i32),
        r2_override=k(r.r2_override, i32),
        initial_pe=k(r.initial_pe, i32),
        arrival_scale=k(r.arrival_scale, f32, open_loop),
        prog_fail_rate=k(r.prog_fail_rate, f32, faults_on),
        erase_fail_rate=k(r.erase_fail_rate, f32, faults_on),
        max_read_retries=k(r.max_read_retries, i32, faults_on),
        fault_seed=k(r.fault_seed, i32, faults_on),
        read_fail_rate=k(r.read_fail_rate, f32, faults_on),
        fault_wear_slope=k(r.fault_wear_slope, f32, faults_on),
        parity_rebuild=k(int(r.parity_rebuild), i32, faults_on),
        spare_blocks=k(r.spare_blocks, i32, faults_on),
        gc_objective=k(reclaim.GC_OBJECTIVE_CODES[r.gc_objective], i32,
                       spec.gc_objective != ("min_valid",)),
    )


def run_one(cfg: geometry.SimConfig, chunks, has_writes: bool,
            knobs: policies.RunKnobs, device) -> st.SSDState:
    """One run of a group: the reference's vmapped body for one lane —
    ``init_state`` from the knobs, then ``step_chunk`` over the chunks."""
    s = st.init_state(cfg, initial_pe=knobs.initial_pe,
                      spare_blocks=knobs.spare_blocks, device=device)
    for req in chunks:
        s, _ = engine.step_chunk(s, req, cfg, has_writes, knobs)
    return s


def visible_devices(device=None) -> list[torch.device]:
    """The devices of ``device``'s kind a sweep could use: every visible card
    for CUDA (CUDA unless the caller names a device), the one named device
    otherwise."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def resolve_devices(devices, device=None) -> tuple[torch.device, ...]:
    """Normalize the ``devices`` argument to a tuple of torch devices.
    Accepts ``None`` (the one ``device``), an int count, ``"all"``, an
    explicit device sequence, or a numeric string, so CLI entry points can
    forward their ``--devices`` argument verbatim. A count above the
    visible devices clamps to them with a warning; below 1 raises."""
    device = resolve_device(device)
    if devices is None:
        return (device,)
    if devices == "all":
        return tuple(visible_devices(device))
    if isinstance(devices, str):
        devices = int(devices)
    if isinstance(devices, int):
        avail = visible_devices(device)
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if devices > len(avail):
            # clamp-and-warn rather than abort: an over-asked sweep on a
            # smaller host still runs with the same results
            warnings.warn(
                f"requested {devices} devices but only {len(avail)} visible; "
                f"clamping to {len(avail)}",
                stacklevel=2,
            )
            devices = len(avail)
        if devices == 1:
            return (device,)
        return tuple(avail[:devices])
    return tuple(torch.device(d) for d in devices)


def assert_results_identical(a, b):
    """Assert two ``run_sweep`` result lists are the same runs in the same
    order with every summarize value exactly equal. Raises explicitly (not
    bare ``assert``) so the guarantee holds under ``python -O``."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} runs vs {len(b)}")
    for ra, rb in zip(a, b):
        if ra["run"] != rb["run"]:
            raise AssertionError(f"run order diverged: {ra['run']} vs {rb['run']}")
        if ra.keys() != rb.keys():
            raise AssertionError(f"metric keys diverged for {ra['run']['tag']}")
        for k in ra:
            if k != "run":
                np.testing.assert_array_equal(
                    np.asarray(ra[k]), np.asarray(rb[k]),
                    err_msg=f"{ra['run']['tag']}/{k}",
                )


def _group_ckpt_path(resume_dir, spec: SweepSpec, pol: int) -> Path:
    return (Path(resume_dir)
            / f"ckpt_{spec.scenario}_{geometry.POLICY_NAMES[pol]}.json")


def _load_group_checkpoint(path: Path, expect_tags, spec: SweepSpec,
                           threads: int):
    """Completed-group results from a prior run, or None when absent/stale.

    A checkpoint is only honored when its run tags (which encode every knob
    of every run in order), request count and thread model match — anything
    else is a different experiment and must re-run."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if (doc.get("tags") != expect_tags
            or doc.get("n_requests") != spec.n_requests
            or doc.get("threads") != threads):
        return None
    return doc["results"]


def _write_group_checkpoint(path: Path, expect_tags, spec: SweepSpec,
                            threads: int, group_results) -> None:
    """Persist one completed policy group. Write-then-rename so a kill
    mid-write never leaves a truncated checkpoint; JSON float round-trips
    are exact in Python 3, so resumed results satisfy
    :func:`assert_results_identical` against an uninterrupted run."""
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = dict(tags=expect_tags, n_requests=spec.n_requests, threads=threads,
               results=group_results)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc))
    tmp.replace(path)


def _retry_delays(max_retries: int, backoff_s: float):
    return [backoff_s * (2 ** i) for i in range(max_retries)]


def _run_meta(r: RunSpec, spec: SweepSpec) -> dict:
    return dict(
        scenario=r.scenario,
        policy=geometry.POLICY_NAMES[r.policy],
        initial_pe=r.initial_pe,
        seed=r.seed,
        r1=r.r1,
        r2_override=r.r2_override,
        arrival_scale=r.arrival_scale,
        prog_fail_rate=r.prog_fail_rate,
        erase_fail_rate=r.erase_fail_rate,
        max_read_retries=r.max_read_retries,
        fault_seed=r.fault_seed,
        read_fail_rate=r.read_fail_rate,
        fault_wear_slope=r.fault_wear_slope,
        parity_rebuild=r.parity_rebuild,
        spare_blocks=r.spare_blocks,
        gc_objective=r.gc_objective,
        n_requests=spec.n_requests,
        tag=r.tag(),
    )


def run_sweep(spec: SweepSpec, threads: int = 4, verbose: bool = False,
              devices=None, resume_dir=None, max_retries: int = 2,
              retry_backoff_s: float = 0.5, device=None):
    """Execute the grid on ``device`` (CUDA unless the caller names one).
    Returns one result dict per run: everything from ``engine.summarize``
    (mean + p50/p95/p99/p999 read latency, IOPS, capacity, ...) plus the
    run's metadata under ``"run"``, in the reference's run order.

    ``devices`` is validated as the reference validates it (an int N,
    ``"all"`` or a device sequence; see :func:`resolve_devices`), but the
    runs execute on one device: a count that resolves above one raises
    ``NotImplementedError`` rather than running on fewer devices than
    asked (a multi-card sweep waits in ROADMAP.md, queue 1, with the
    parallelism item).

    Robustness (DESIGN.md §2D): ``resume_dir`` checkpoints each completed
    policy group to disk and deterministically resumes from matching
    checkpoints on a rerun — a killed sweep repeats only the unfinished
    groups and the merged results are identical to an uninterrupted run.
    A group that raises is retried ``max_retries`` times with exponential
    backoff (``retry_backoff_s`` doubling per attempt); a group still
    failing after that does not lose the rest of the grid — every other
    group completes (and checkpoints) before a ``RuntimeError`` names the
    failed groups.
    """
    devs = resolve_devices(devices, device)  # validate before the trace-build cost
    if len(devs) > 1:
        raise NotImplementedError(
            f"a sweep over {len(devs)} devices is not ported; it runs on one "
            "device (devices=None or 1). A multi-card sweep waits in "
            "ROADMAP.md, queue 1, with the parallelism item")
    dev = devs[0]
    runs = expand(spec)
    kw = dict(spec.scenario_kw)
    if len(spec.seeds) > 1 and registry.is_seed_invariant(spec.scenario):
        warnings.warn(
            f"scenario {spec.scenario!r} is deterministic w.r.t. seed; "
            f"{len(spec.seeds)} seeds will produce identical runs",
            stacklevel=2,
        )

    # traces depend only on (scenario, seed): build each once, share across
    # policies/knobs
    traces: dict[int, dict] = {}
    for seed in spec.seeds:
        traces[seed] = registry.build(
            spec.scenario, spec.base, spec.n_requests, seed=seed, **kw
        )
    has_writes = bool(any((t["op"] == engine.OP_WRITE).any() for t in traces.values()))
    open_loop = all("arrival_ms" in t for t in traces.values())
    if spec.arrival_scale != (1.0,) and not open_loop:
        warnings.warn(
            f"scenario {spec.scenario!r} has no arrival timestamps; the "
            f"arrival_scale axis {spec.arrival_scale} has no effect on "
            "closed-loop runs",
            stacklevel=2,
        )
    if not open_loop:  # a mixed set of traces runs closed loop, as the reference's
        traces = {seed: {k: t[k] for k in ("lpn", "op")} for seed, t in traces.items()}
    chunks: dict[int, list] = {}  # each seed's trace on the device, uploaded once

    def run_group(group, cfg):
        out = []
        for r in group:
            if r.seed not in chunks:
                chunks[r.seed] = engine.trace_chunks(traces[r.seed], dev)
            knobs = run_knobs(r, spec, open_loop, dev)
            s = run_one(cfg, chunks[r.seed], has_writes, knobs, dev)
            m = engine.summarize(s, cfg, threads=threads)
            m["run"] = _run_meta(r, spec)
            out.append(m)
        return out

    results = []
    failed = []
    for pol in spec.policies:  # one group per policy
        group = [r for r in runs if r.policy == pol]
        cfg = replace(spec.base, policy=pol)
        name = geometry.POLICY_NAMES[pol]
        expect_tags = [r.tag() for r in group]
        ckpt = _group_ckpt_path(resume_dir, spec, pol) if resume_dir is not None else None
        if ckpt is not None:
            cached = _load_group_checkpoint(ckpt, expect_tags, spec, threads)
            if cached is not None:
                if verbose:
                    print(f"# sweep group policy={name}: {len(group)} runs "
                          "resumed from checkpoint", flush=True)
                results.extend(cached)
                continue
        if verbose:
            print(f"# sweep group policy={name}: {len(group)} runs one by one "
                  f"on {dev}", flush=True)
        group_results = None
        last_err = None
        delays = _retry_delays(max_retries, retry_backoff_s)
        for attempt in range(max_retries + 1):
            try:
                group_results = run_group(group, cfg)
                break
            except Exception as e:  # one failed group must not lose the grid
                last_err = e
                if attempt < max_retries:
                    warnings.warn(
                        f"sweep group {name!r} failed ({e!r}); retry "
                        f"{attempt + 1}/{max_retries} in "
                        f"{delays[attempt]:.1f}s",
                        stacklevel=2,
                    )
                    time.sleep(delays[attempt])
        if group_results is None:
            failed.append((name, last_err))
            continue
        if ckpt is not None:
            _write_group_checkpoint(ckpt, expect_tags, spec, threads, group_results)
        results.extend(group_results)
    if failed:
        names = ", ".join(n for n, _ in failed)
        hint = (
            "completed groups were checkpointed to resume_dir and are "
            "reused on rerun" if resume_dir is not None else
            "pass resume_dir= to checkpoint completed groups across reruns"
        )
        raise RuntimeError(
            f"sweep group(s) failed after {max_retries} retries: {names} "
            f"({hint})"
        ) from failed[0][1]
    return results


# --------------------------- result artifacts ------------------------------

# Scalar metric names + units come from the single schema registry
# (ssdsim/metrics_schema.py); the name is kept for backward compatibility.
_ROW_UNITS = metrics_schema.row_units()


def result_rows(res: dict, prefix: str = "sweep"):
    """Flatten one run result into harness-style (name, value, unit) rows."""
    tag = res["run"]["tag"]
    rows = [
        (f"{prefix}/{tag}/{k}", float(res[k]), u)
        for k, u in _ROW_UNITS.items()
        if k in res
    ]
    # per-mode observability readout (present at obs_level="full"):
    # retry share of each mode's p99 tail mass (DESIGN.md §7.4)
    if "tail_retry_share" in res:
        rows += [
            (f"{prefix}/{tag}/tail_retry_share_{name.lower()}",
             float(v), "fraction")
            for name, v in zip(modes.MODE_NAMES, res["tail_retry_share"])
        ]
    return rows


def _json_safe(v):
    """Summarize values are floats, nested lists, or ndarrays — normalize
    all three to JSON-native types."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return float(v)


def write_artifacts(results, out_dir, prefix: str = "sweep") -> list[Path]:
    """One ``BENCH_<tag>.json`` per run, mirroring the harness CSV rows so
    artifacts and stdout stay diffable against each other."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for res in results:
        doc = {
            "name": f"{prefix}/{res['run']['tag']}",
            "run": res["run"],
            "metrics": {
                k: _json_safe(v) for k, v in res.items() if k != "run"
            },
            "rows": [list(r) for r in result_rows(res, prefix)],
        }
        p = out / f"BENCH_{prefix}_{res['run']['tag']}.json"
        p.write_text(json.dumps(doc, indent=1, sort_keys=True))
        paths.append(p)
    return paths
