"""Helpers of the twins of the reference's Layer A and controller tests
(``tests/test_torch_<stem>.py``, one per reference ``tests/test_<stem>.py``):

- ``one_torch_thread``, an autouse fixture for the modules that import it;
- tensors from the numbers and numpy arrays the reference passes to its
  functions (the port's functions take tensors);
- the port's engine on the CPU (``run``), and its stand-in for the
  reference sweep's batched runner (``knob_runs``: one
  ``experiments.sweep.run_one`` per run where the reference calls
  ``sweep._sweep_jit`` and takes each run with ``sweep._take_run``);
- the trace and config that ``tests/test_faults.py`` and
  ``tests/test_wearout.py`` both build;
- the one comparison per twin file with the JAX package
  (``check_against_reference``), by ``torch_ssd_compare``'s rule.

Not collected (no ``test_`` prefix).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_ssd_compare import compare_leaves, compare_summaries

from repro_torch.experiments import sweep
from repro_torch.ssdsim import engine, geometry, policies, workload

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a twin module's tests (autouse where a module
    imports it): the port's engine runs many small ops, and a parallel test
    run shares the machine's cores among its workers, where more threads a
    worker make each op many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def i32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def run(cfg, trace):
    """``engine.run`` on the CPU: (final state, stacked chunk metrics)."""
    return engine.run(cfg, trace, device=CPU)


def knob_runs(cfg, trace, knobs: dict) -> list:
    """The port's ``sweep._sweep_jit(cfg, lpns, ops, True, knobs, None)``
    with ``sweep._take_run(states, i)`` for each run ``i``: ``knobs`` maps
    ``RunKnobs`` fields to arrays with one entry per run (the reference's
    stacked knobs), every run steps the same trace with writes on, and each
    run's final state is returned in run order."""
    n = len(next(iter(knobs.values())))
    chunks = engine.trace_chunks(trace, CPU)
    return [sweep.run_one(cfg, chunks, True,
                          policies.RunKnobs(**{k: torch.tensor(np.asarray(v)[i])
                                               for k, v in knobs.items()}), CPU)
            for i in range(n)]


def mixed(cfg, n=4_096, seed=1, read_frac=0.7, write_theta=None):
    """``tests/test_faults.py`` and ``tests/test_wearout.py``'s ``_mixed``."""
    return workload.mixed_trace(cfg, n, 1.2, read_frac=read_frac, seed=seed,
                                write_theta=write_theta)


def pressure_cfg(**kw):
    """The gc_pressure shape of ``tests/test_faults.py`` and
    ``tests/test_wearout.py``: a tiny free pool under write-heavy Zipf
    overwrites, so GC erases fire on nearly every chunk."""
    base = dict(policy=geometry.BASELINE, initial_pe=500, n_logical=2_944,
                gc_free_threshold=18, gc_victims_per_pass=4,
                erase_fail_rate=0.1, fault_seed=1)
    base.update(kw)
    return geometry.tiny_config(**base)


# ---------------------------------------------------------------------------
# the one comparison per file with the JAX package
# ---------------------------------------------------------------------------

def reference_config(cfg):
    """The reference's SimConfig with every field of the port's."""
    from repro.core import hotness as j_hot
    from repro.ssdsim import geometry as j_geo

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["heat"] = j_hot.HeatConfig(*fields["heat"])
    return j_geo.SimConfig(**fields)


def check_against_reference(cfg, trace, state):
    """Run the JAX engine once on ``trace`` under ``cfg`` (the port's
    config, mirrored) and hold the port's final ``state`` and its summary to
    it: integers exact, floats rtol 1e-5, histograms within one bin. (No
    twin compares an open-loop lattice run at obs level "full", the one
    place ``lindley_loose`` would apply.)"""
    from repro.ssdsim import engine as j_eng
    from repro.ssdsim import state as j_st

    j_cfg = reference_config(cfg)
    js, _ = j_eng.run(j_cfg, trace)
    bad = compare_leaves(j_st.SSDState._fields, js, state)
    bad += compare_summaries(j_eng.summarize(js, j_cfg), engine.summarize(state, cfg))
    assert not bad, "\n".join(bad)
