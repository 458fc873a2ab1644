"""The port's host-side simulator modules against the JAX package's on the
CPU: the copies' tables and constants (``ssdsim.geometry``,
``metrics_schema``, ``workload``) equal the reference's, and
``telemetry``'s bins and quantiles and ``obs``' host decoders agree.

Tolerances: tables, traces, configs and decoders exact; latency bins
against the jitted reference exact on these inputs, with the rule that a
latency on a bin edge may land one bin over checked as equal totals and no
count moved by more than one bin.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_ssd_parity import port_config, within_one_bin

from repro.ssdsim import engine as j_eng
from repro.ssdsim import geometry as j_geo
from repro.ssdsim import metrics_schema as j_ms
from repro.ssdsim import obs as j_obs
from repro.ssdsim import telemetry as j_tel
from repro.ssdsim import workload as j_wl
from repro_torch import convert
from repro_torch.ssdsim import engine, geometry, metrics_schema, obs, telemetry, workload


# ------------------------------ geometry -----------------------------------

def test_simconfig_fields_and_defaults_equal():
    j_fields = [(f.name, f.default) for f in dataclasses.fields(j_geo.SimConfig)
                if f.name != "heat"]
    t_fields = [(f.name, f.default) for f in dataclasses.fields(geometry.SimConfig)
                if f.name != "heat"]
    assert t_fields == j_fields
    assert tuple(geometry.SimConfig().heat) == tuple(j_geo.SimConfig().heat)
    for name in ("CHAN_MODELS", "GC_OBJECTIVES", "ALLOC_POLICIES", "BASELINE", "HOTNESS",
                 "RARO", "POLICY_NAMES"):
        assert getattr(geometry, name) == getattr(j_geo, name), name


CONFIGS = {
    "table_iii": {},
    "tiny": None,
    "endurance": dict(blocks_per_plane=64, slots_per_block=256, n_logical=57_344, chunk=256,
                      gc_free_threshold=24),
    "one_channel_planes": dict(n_channels=1, luns_per_channel=4, planes_per_lun=2,
                               slots_per_block=96, page_kib=4, channel_mb_s=533.0),
}


def _configs(name):
    kw = CONFIGS[name]
    if kw is None:
        return j_geo.tiny_config(), geometry.tiny_config()
    return j_geo.SimConfig(**kw), geometry.SimConfig(**kw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_properties_and_lattice_math(name):
    j_cfg, t_cfg = _configs(name)
    assert dataclasses.asdict(port_config(j_cfg, geometry)) == dataclasses.asdict(t_cfg)
    for prop in ("n_luns", "n_dies", "planes_per_die", "n_blocks", "n_slots", "page_bytes",
                 "faults_enabled", "transfer_us", "rebuild_xfer_chain"):
        assert getattr(t_cfg, prop) == getattr(j_cfg, prop), prop
    blk = np.arange(t_cfg.n_blocks, dtype=np.int32)
    tb = torch.from_numpy(blk)
    for fn in ("die_of_block", "plane_of_block", "plane_slot_of_block"):
        np.testing.assert_array_equal(getattr(t_cfg, fn)(tb).numpy(),
                                      np.asarray(getattr(j_cfg, fn)(blk)))
    die = blk % t_cfg.n_dies
    np.testing.assert_array_equal(t_cfg.channel_of_die(torch.from_numpy(die)).numpy(),
                                  np.asarray(j_cfg.channel_of_die(die)))
    np.testing.assert_array_equal(geometry.pages_per_block_host(t_cfg),
                                  j_geo.pages_per_block_host(j_cfg))
    ppb = geometry.pages_per_block(t_cfg, "cpu")
    assert ppb.dtype == torch.int32
    np.testing.assert_array_equal(ppb.numpy(), np.asarray(j_geo.pages_per_block(j_cfg)))


@pytest.mark.parametrize("bad", [dict(chan_model="mesh"), dict(gc_objective="oldest"),
                                 dict(alloc_policy="oldest"), dict(fault_wear_power=0.0)])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        j_geo.SimConfig(**bad)
    with pytest.raises(ValueError):
        geometry.SimConfig(**bad)


def test_deprecated_aliases_warn():
    cfg = geometry.tiny_config()
    geometry._ALIAS_WARNED.clear()
    with pytest.warns(DeprecationWarning):
        assert cfg.lun_of_block(5) == cfg.die_of_block(5)
    with pytest.warns(DeprecationWarning):
        assert cfg.channel_of_lun(3) == cfg.channel_of_die(3)
    assert cfg.with_policy(geometry.BASELINE).policy == geometry.BASELINE


# --------------------------- metrics_schema --------------------------------

def test_metrics_schema_equal():
    assert list(metrics_schema.SCHEMA) == list(j_ms.SCHEMA)
    for k, m in j_ms.SCHEMA.items():
        assert tuple(metrics_schema.SCHEMA[k]) == tuple(m), k
    assert metrics_schema.units() == j_ms.units()
    assert metrics_schema.row_units() == j_ms.row_units()
    assert tuple(metrics_schema.describe("iops")) == tuple(j_ms.describe("iops"))


# ------------------------------ workload -----------------------------------

def _trace_cases():
    return [
        ("zipf_read_trace", (5000, 1.2), dict(seed=3)),
        ("zipf_read_trace", (777, 0.9), dict(seed=1, hot_fraction_cap=0.1,
                                             arrival_rate=50_000.0)),
        ("zipf_read_trace", (1000, 1.2), dict(arrival_rate=20_000.0, arrival_dist="constant")),
        ("seq_read_trace", (1000,), dict(start=1500)),
        ("uniform_read_trace", (3000,), dict(seed=5)),
        ("mixed_trace", (4000, 1.2), dict(read_frac=0.3, write_theta=2.0, seed=2)),
        ("mixed_trace", (2500, 0.8), dict(seed=4, arrival_rate=10_000.0)),
    ]


@pytest.mark.parametrize("case", range(len(_trace_cases())))
def test_traces_equal(case):
    name, args, kw = _trace_cases()[case]
    j_cfg, t_cfg = j_geo.tiny_config(), geometry.tiny_config()
    ref = getattr(j_wl, name)(j_cfg, *args, **kw)
    out = getattr(workload, name)(t_cfg, *args, **kw)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        np.testing.assert_array_equal(out[k], ref[k])


def test_arrivals_and_op_codes():
    assert (workload.OP_READ, workload.OP_WRITE) == (j_wl.OP_READ, j_wl.OP_WRITE)
    assert (engine.OP_READ, engine.OP_WRITE) == (j_eng.OP_READ, j_eng.OP_WRITE)
    for dist in ("poisson", "constant"):
        np.testing.assert_array_equal(workload.build_arrivals(999, 3e4, dist, seed=2),
                                      j_wl.build_arrivals(999, 3e4, dist, seed=2))
    with pytest.raises(ValueError):
        workload.build_arrivals(10, 1e3, "bursty")
    j_cfg, t_cfg = j_geo.tiny_config(), geometry.tiny_config()
    tr = j_wl.mixed_trace(j_cfg, 1000, 1.1, seed=9)
    ref = j_wl.attach_arrivals(j_cfg, tr, 25_000.0, seed=4)
    out = workload.attach_arrivals(t_cfg, tr, 25_000.0, seed=4)
    np.testing.assert_array_equal(out["arrival_ms"], ref["arrival_ms"])
    np.testing.assert_array_equal(workload.zipf_probs(100, 1.2), j_wl.zipf_probs(100, 1.2))


# ------------------------------ telemetry ----------------------------------

def test_bin_edges_equal():
    np.testing.assert_array_equal(telemetry.bin_edges_us(), j_tel.bin_edges_us())
    assert (telemetry.N_LAT_BINS, telemetry.LAT_MIN_US, telemetry.BINS_PER_DECADE) == (
        j_tel.N_LAT_BINS, j_tel.LAT_MIN_US, j_tel.BINS_PER_DECADE)


@pytest.mark.parametrize("seed", [0, 1])
def test_latency_bins_and_record(seed):
    rng = np.random.default_rng(seed)
    n = 100_000
    lat = np.concatenate([
        (10 ** (rng.random(n) * 5)).astype(np.float32),  # 1 µs .. 100 ms, past both ends
        np.asarray(j_tel.bin_edges_us(), np.float32),  # latencies on the bin edges
        np.array([20.0, 66.0, 140.0, 160.48, 2380.0, 3122.48], np.float32),
    ])
    ref = np.asarray(jax.jit(j_tel.latency_bin)(lat))
    out = telemetry.latency_bin(torch.from_numpy(lat))
    assert out.dtype == torch.int32
    assert (np.abs(out.numpy() - ref) <= 1).all()
    mask = rng.random(lat.shape[0]) < 0.8
    hist0 = (rng.integers(0, 5, telemetry.N_LAT_BINS)).astype(np.float32)
    h_ref = np.asarray(jax.jit(j_tel.record)(hist0, lat, mask))
    h_out = telemetry.record(torch.from_numpy(hist0), torch.from_numpy(lat),
                             torch.from_numpy(mask)).numpy()
    assert within_one_bin(h_ref, h_out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_and_quantile_bin(seed):
    rng = np.random.default_rng(seed)
    hists = [np.zeros(telemetry.N_LAT_BINS), rng.integers(0, 50, telemetry.N_LAT_BINS) *
             (rng.random(telemetry.N_LAT_BINS) < 0.3)]
    h = np.zeros(telemetry.N_LAT_BINS)
    h[[3, 40]] = [7, 1]  # quantile targets on an exact cumulative boundary
    hists.append(h)
    for h in hists:
        assert telemetry.percentiles(h) == j_tel.percentiles(h)
        for q in (0.5, 0.875, 0.99, 0.999):
            assert telemetry.quantile_bin(h, q) == j_tel.quantile_bin(h, q)


# --------------------------------- obs -------------------------------------

def test_obs_constants_equal():
    for name in ("LEVELS", "COMPONENT_NAMES", "N_COMPONENTS", "N_EV_FIELDS", "REASON_NAMES",
                 "SERIES_NAMES", "N_SERIES", "REASON_GC", "REASON_RECLAIM", "REASON_CONV_PAGE",
                 "REASON_CONV_BLOCK", "REASON_BAD_BLOCK", "TS_RELOC", "EV_PAGES"):
        assert getattr(obs, name) == getattr(j_obs, name), name


@pytest.fixture(scope="module")
def obs_run():
    """One JAX run at obs_level="full" with a small ring (so it wraps)."""
    from repro.ssdsim import engine as je

    cfg = j_geo.tiny_config(policy=j_geo.RARO, initial_pe=500, device_age_h=24.0,
                            obs_level="full", obs_event_capacity=8)
    s, _ = je.run(cfg, j_wl.zipf_read_trace(cfg, 128 * 10, 1.2, seed=1))
    leaves = [np.asarray(x) for x in s]
    return cfg, s, convert.ssd_state_from_numpy(leaves, device="cpu")


def test_obs_host_decoders_equal(obs_run):
    j_cfg, js, ts = obs_run
    t_cfg = port_config(j_cfg, geometry)
    recs, total, dropped = obs.decode_events(ts, t_cfg)
    assert (recs, total, dropped) == j_obs.decode_events(js, j_cfg)
    assert total > 8 and dropped == total - 8
    np.testing.assert_array_equal(obs.event_conversion_matrix(recs),
                                  j_obs.event_conversion_matrix(recs))
    for fn in ("decode_timeseries", "decomposition"):
        ref, out = getattr(j_obs, fn)(js, j_cfg), getattr(obs, fn)(ts, t_cfg)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    assert obs.tail_attribution(ts, t_cfg) == j_obs.tail_attribution(js, j_cfg)
    assert obs.summary(ts, t_cfg) == j_obs.summary(js, j_cfg)


@pytest.mark.parametrize("level", ["off", "counters", "full"])
def test_obs_init_leaves(level):
    j_cfg = j_geo.tiny_config(obs_level=level, obs_event_capacity=16, obs_windows=8)
    t_cfg = port_config(j_cfg, geometry)
    ref, out = j_obs.init_leaves(j_cfg), obs.init_leaves(t_cfg, "cpu")
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].numpy().dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(ValueError):
        obs.init_leaves(dataclasses.replace(t_cfg, obs_level="verbose"), "cpu")
