"""Parity of the port's policy core (repro_torch.core) with repro.core on the
CPU: the same numpy inputs go through both. Integer outputs are exact;
RBER is held to rtol 1e-6 (the two frameworks' pow/log/cos/exp may differ
in the last ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotness as j_hot
from repro.core import modes as j_modes
from repro.core import policy as j_policy
from repro.core import rber as j_rber
from repro.core import retry as j_retry
from repro_torch.core import hotness, modes, policy, rber, retry


def _inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    return dict(
        mode=rng.integers(0, 3, n).astype(np.int32),
        cycles=(rng.random(n) * 3000).astype(np.float32),
        time_h=(rng.random(n) * 200).astype(np.float32),
        reads=(rng.random(n) ** 2 * 5000).astype(np.float32),
        page_ids=rng.integers(0, 2**31 - 1, n).astype(np.int32),
        heat=(rng.random(n) * 0.2).astype(np.float32),
    )


@pytest.mark.parametrize("name", [
    "BITS_PER_CELL", "N_SENSE", "MAX_RETRIES", "PAGES_PER_BLOCK", "READ_LATENCY_US",
    "WRITE_LATENCY_US", "ERASE_LATENCY_US", "STAGE_BOUNDS", "TIER_BITS",
])
def test_mode_tables_equal(name):
    ref = np.asarray(getattr(j_modes, name))
    out = modes.table(getattr(modes, name), "cpu").numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_mode_ids_equal():
    for name in ("SLC", "TLC", "QLC", "N_MODES", "COLD", "WARM", "HOT", "TIER_BF16",
                 "TIER_INT8", "TIER_INT4", "STAGE_YOUNG", "STAGE_MIDDLE", "STAGE_OLD"):
        assert getattr(modes, name) == getattr(j_modes, name), name
    assert modes.TIER_NAMES == j_modes.TIER_NAMES
    assert modes.RATED_PE == j_modes.RATED_PE


@pytest.mark.parametrize("seed", [0, 1])
def test_hotness_decay_and_classify(seed):
    x = _inputs(seed)
    hc = j_hot.HeatConfig(decay=0.95, hot_thresh=0.08, warm_thresh=0.02)
    tc = hotness.HeatConfig(*hc)
    h = torch.from_numpy(x["heat"])
    np.testing.assert_array_equal(hotness.decay_heat(h, tc).numpy(),
                                  np.asarray(j_hot.decay_heat(jnp.asarray(x["heat"]), hc)))
    # thresholds exactly on the grid of values: ties must classify the same
    edges = np.array([0.08, 0.02, np.nextafter(np.float32(0.08), 0), 0.0], np.float32)
    hv = np.concatenate([x["heat"], edges])
    out = hotness.classify(torch.from_numpy(hv), tc)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_hot.classify(jnp.asarray(hv), hc)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migration_decision(seed):
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 3, 2048).astype(np.int32)
    cls = rng.integers(0, 3, 2048).astype(np.int32)
    retries = rng.integers(0, 17, 2048).astype(np.int32)
    r2 = rng.integers(1, 12, 2048).astype(np.int32)
    ref = j_policy.migration_decision(mode, cls, retries,
                                      j_policy.Thresholds(jnp.int32(1), jnp.asarray(r2)))
    out = policy.migration_decision(torch.from_numpy(mode), torch.from_numpy(cls),
                                    torch.from_numpy(retries),
                                    policy.Thresholds(1, torch.from_numpy(r2)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_page_variation_hash_bit_exact(seed):
    ids = _inputs(seed)["page_ids"]
    ids = np.concatenate([ids, np.array([0, 1, 2**31 - 1, 12345], np.int32)])
    h = rber._hash_u32(torch.from_numpy(ids)).numpy().astype(np.uint32)
    # the reference's hash, replayed in numpy uint32 (wrapping) arithmetic
    r = ids.astype(np.uint32)
    with np.errstate(over="ignore"):
        r = r * np.uint32(0x9E3779B9)
        r = r ^ (r >> np.uint32(16))
        r = r * np.uint32(0x85EBCA6B)
        r = r ^ (r >> np.uint32(13))
        r = r * np.uint32(0xC2B2AE35)
        r = r ^ (r >> np.uint32(16))
    np.testing.assert_array_equal(h, r)
    np.testing.assert_allclose(rber.page_variation(torch.from_numpy(ids)).numpy(),
                               np.asarray(j_rber.page_variation(ids)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_rber_and_retries(seed):
    x = _inputs(seed)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ref = np.asarray(j_rber.page_rber(x["mode"], x["cycles"], x["time_h"], x["reads"],
                                      x["page_ids"]))
    out = rber.page_rber(t["mode"], t["cycles"], t["time_h"], t["reads"], t["page_ids"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)

    # retries from the SAME rber input: the ceil of Eq. 3 is exact
    n_ref = np.asarray(j_retry.retry_count(x["mode"], ref))
    n_out = retry.retry_count(t["mode"], torch.tensor(ref))
    assert n_out.dtype == torch.int32
    np.testing.assert_array_equal(n_out.numpy(), n_ref)
    # and the whole pipeline; an ulp in log/cos could move a ceil, and this
    # pins that it does not on these inputs
    full_ref = np.asarray(j_retry.page_retries(x["mode"], x["cycles"], x["time_h"],
                                               x["reads"], x["page_ids"]))
    full = retry.page_retries(t["mode"], t["cycles"], t["time_h"], t["reads"], t["page_ids"])
    np.testing.assert_array_equal(full.numpy(), full_ref)
