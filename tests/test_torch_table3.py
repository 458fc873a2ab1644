"""Layer A at the paper's Table III geometry (``SimConfig()``: 1,024 blocks
× 1,024 slots, 524,288 logical pages, chunks of 1,024) through both
packages on the CPU: ``examples/quickstart.py``'s three policies at MIDDLE
wear (P/E 500, 24 h) on its zipf-1.2 trace (seed 1), over the trace's first
16 chunks. Final state, per-chunk metrics and ``summarize`` are held by
``tests/torch_ssd_compare.py``'s rule: integers exact, floats rtol 1e-5,
histograms within one bin. The other Layer A parity tests run
``tiny_config``; this one runs the full geometry.
"""

import numpy as np
import pytest
import torch_ssd_parity as parity

from repro_torch.configs import raro_ssd
from repro_torch.ssdsim import engine, geometry, workload

N_CHUNKS = 16
QUICKSTART_REQUESTS = 100_000


@pytest.fixture(scope="module", params=["baseline", "hotness", "raro"])
def case(request):
    from repro.core import hotness as j_hot
    from repro.ssdsim import engine as j_eng
    from repro.ssdsim import geometry as j_geo

    pol = geometry.POLICY_NAMES.index(request.param)
    cfg = geometry.SimConfig(policy=pol, initial_pe=raro_ssd.MIDDLE.initial_pe,
                             device_age_h=raro_ssd.MIDDLE.device_age_h)
    j_cfg = j_geo.SimConfig(policy=pol, initial_pe=500, device_age_h=24.0)
    assert parity.port_config(j_cfg, geometry) == cfg and isinstance(j_cfg.heat, j_hot.HeatConfig)
    tr = workload.zipf_read_trace(cfg, QUICKSTART_REQUESTS, 1.2, seed=1)
    tr = {k: v[:N_CHUNKS] for k, v in tr.items()}
    return request.param, j_cfg, cfg, j_eng.run(j_cfg, tr), engine.run(cfg, tr, device="cpu")


def test_geometry_is_table3(case):
    _, _, cfg, _, (s, _) = case
    assert (cfg.n_blocks, cfg.slots_per_block, cfg.n_logical, cfg.chunk) == (
        1024, 1024, 524_288, 1024)
    assert s.p2l.shape == (1024 * 1024,)


def test_state_matches_reference(case):
    name, j_cfg, cfg, (js, _), (ts, _) = case
    from repro.ssdsim import state as j_st

    bad = parity.compare_leaves(j_st.SSDState._fields, js, ts, where=f"{name}: ")
    assert not bad, "\n".join(bad)


def test_chunk_metrics_match_reference(case):
    name, _, _, (_, jm), (_, tm) = case
    from repro.ssdsim import engine as j_eng

    bad = parity.compare_leaves(j_eng.ChunkMetrics._fields, jm, tm, where=f"{name} metrics: ")
    assert not bad, "\n".join(bad)


def test_summary_matches_reference(case):
    name, j_cfg, cfg, (js, _), (ts, _) = case
    from repro.ssdsim import engine as j_eng

    ref, out = j_eng.summarize(js, j_cfg), engine.summarize(ts, cfg)
    bad = parity.compare_summaries(ref, out)
    assert not bad, "\n".join(bad)
    # the case reaches its policy's path: only the converting policies migrate
    assert (out["migrated_pages"] > 0) == (name != "baseline")
    assert out["reads"] == N_CHUNKS * cfg.chunk and np.isfinite(out["iops"])
