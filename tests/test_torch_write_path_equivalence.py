"""The port's batched write path against its sequential oracle, the twin of
``tests/test_write_path_equivalence.py``: ``engine.write_path_batched`` must
give the state ``engine.write_path_reference`` gives on arbitrary mixed
traces — duplicate LPNs within a chunk, open-block rollover mid-chunk,
allocation failure when the free pool runs out. Integer and mapping state
exact; float accumulators (busy time) rtol 1e-5 and atol 1e-5, since they
differ by summation order only (the reference's own tolerance).

``test_oracle_matches_reference`` holds the port's oracle against the JAX
package's on the same chunks, by ``tests/torch_ssd_compare.py``'s rule
(integers exact, floats rtol 1e-5, histograms within one bin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hyp_fallback import given, settings
from hyp_fallback import st as st_h
from torch_ssd_compare import compare_leaves

from repro_torch.ssdsim import engine, geometry, state as st, workload

TINY = geometry.tiny_config()
CPU = "cpu"


def assert_state_equivalent(s_ref: st.SSDState, s_bat: st.SSDState, tag=""):
    for name, a, b in zip(s_ref._fields, s_ref, s_bat):
        a, b = a.numpy(), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5, err_msg=f"{tag}: float field {name}"
            )
        else:
            bad = np.nonzero(np.atleast_1d(a != b))[0]
            assert (a == b).all(), (
                f"{tag}: field {name} differs at {bad[:8]}: "
                f"ref={np.atleast_1d(a)[bad][:8]} bat={np.atleast_1d(b)[bad][:8]}"
            )


def _run_both(s0, lpns, is_write, cfg):
    s_ref = engine.write_path_reference(s0, lpns, is_write, cfg)
    s_bat = engine.write_path_batched(s0, lpns, is_write, cfg)
    st.check_invariants(s_bat, cfg, "batched write path")
    return s_ref, s_bat


@settings(max_examples=12, deadline=None)
@given(
    seed=st_h.integers(0, 2**16),
    theta=st_h.floats(0.6, 1.5),
    read_frac=st_h.floats(0.0, 0.9),
)
def test_property_write_paths_equivalent(seed, theta, read_frac):
    """Random mixed traces, chunk by chunk, comparing full state each step.
    Zipf LPNs give duplicate writes within a chunk; chunk (128) > QLC pages
    per block (64) makes open-block rollover routine."""
    cfg = TINY
    tr = workload.mixed_trace(cfg, 3 * cfg.chunk, theta, read_frac=read_frac, seed=seed)
    s_ref = s_bat = st.init_state(cfg, device=CPU)
    for i in range(tr["lpn"].shape[0]):
        lp = torch.from_numpy(tr["lpn"][i])
        w = torch.from_numpy(tr["op"][i]) == engine.OP_WRITE
        s_ref = engine.write_path_reference(s_ref, lp, w, cfg)
        s_bat = engine.write_path_batched(s_bat, lp, w, cfg)
        assert_state_equivalent(s_ref, s_bat, tag=f"chunk {i}")
        st.check_invariants(s_bat, cfg, f"chunk {i}")


def test_single_lun_rollover_equivalent():
    """All writes on one LUN: the chunk spans two fresh blocks (128 > 64)."""
    cfg = TINY
    s0 = st.init_state(cfg, device=CPU)
    lp = torch.from_numpy(((np.arange(cfg.chunk) * cfg.n_luns) % cfg.n_logical).astype(np.int32))
    w = torch.ones(cfg.chunk, dtype=torch.bool)
    s_ref, s_bat = _run_both(s0, lp, w, cfg)
    assert_state_equivalent(s_ref, s_bat, "rollover")
    assert float(s_bat.n_writes) == cfg.chunk


def test_duplicate_lpns_equivalent():
    """A handful of LPNs overwritten many times in one chunk: only the last
    write of each maps; earlier ones consume slots and are invalidated."""
    cfg = TINY
    s0 = st.init_state(cfg, device=CPU)
    lp = torch.from_numpy(np.tile([0, 1, 4, 5], cfg.chunk // 4).astype(np.int32))
    w = torch.ones(cfg.chunk, dtype=torch.bool)
    s_ref, s_bat = _run_both(s0, lp, w, cfg)
    assert_state_equivalent(s_ref, s_bat, "dups")
    l2p = s_bat.l2p.numpy()
    p2l = s_bat.p2l.numpy()
    for lpn in (0, 1, 4, 5):
        assert p2l[l2p[lpn]] == lpn


def test_allocation_failure_mid_chunk_equivalent():
    """Exactly one free block left: one rollover succeeds, the next fails,
    and every later write on that LUN fails identically in both paths."""
    base = geometry.tiny_config()
    cfg = geometry.tiny_config(
        n_logical=base.n_blocks * base.slots_per_block - base.slots_per_block - 32
    )
    s0 = st.init_state(cfg, device=CPU)
    assert int(s0.free_count) == 1
    free_blk = int(np.nonzero(s0.block_state.numpy() == st.FREE)[0][0])
    lun = free_blk % cfg.n_luns
    # every write targets the free block's LUN so the single spare is consumed
    # mid-chunk and the remaining writes hit allocation failure
    lp = torch.from_numpy(
        ((lun + np.arange(cfg.chunk) * cfg.n_luns) % cfg.n_logical).astype(np.int32))
    w = torch.ones(cfg.chunk, dtype=torch.bool)
    s_ref, s_bat = _run_both(s0, lp, w, cfg)
    assert_state_equivalent(s_ref, s_bat, "alloc-failure")
    assert 0 < float(s_bat.n_writes) < cfg.chunk  # partial progress, then fail
    assert int(s_bat.free_count) == 0
    assert int(s_bat.open_user[lun]) == -1


def test_device_full_no_writes_equivalent():
    """Zero free blocks and no open block: every write fails, state (other
    than the open_user reset) is untouched."""
    base = geometry.tiny_config()
    cfg = geometry.tiny_config(n_logical=base.n_blocks * base.slots_per_block - 32)
    s0 = st.init_state(cfg, device=CPU)
    assert int(s0.free_count) == 0
    lp = torch.from_numpy(np.arange(cfg.chunk, dtype=np.int32) % cfg.n_logical)
    w = torch.ones(cfg.chunk, dtype=torch.bool)
    s_ref, s_bat = _run_both(s0, lp, w, cfg)
    assert_state_equivalent(s_ref, s_bat, "device-full")
    assert float(s_bat.n_writes) == 0.0
    np.testing.assert_array_equal(s_bat.l2p.numpy(), s0.l2p.numpy())


def test_reads_never_touch_write_path_state():
    """A pure-read mask is a no-op for both implementations."""
    cfg = TINY
    s0 = st.init_state(cfg, device=CPU)
    lp = torch.from_numpy(np.arange(cfg.chunk, dtype=np.int32))
    w = torch.zeros(cfg.chunk, dtype=torch.bool)
    s_ref, s_bat = _run_both(s0, lp, w, cfg)
    assert_state_equivalent(s_ref, s_bat, "no-writes")
    assert float(s_bat.n_writes) == 0.0
    assert float(s_bat.w_lat_hist.sum()) == 0.0


@pytest.mark.parametrize("case", ["mixed", "alloc_failure"])
def test_oracle_matches_reference(case):
    """The port's ``write_path_reference`` against the JAX package's, chunk
    after chunk from the same pre-filled state: a zipf read/write trace with
    rollovers and duplicate LPNs, and a device one free block from full."""
    from repro.ssdsim import engine as j_eng
    from repro.ssdsim import geometry as j_geo
    from repro.ssdsim import state as j_st

    if case == "mixed":
        kw = {}
        tr = workload.mixed_trace(geometry.tiny_config(), 3 * TINY.chunk, 1.1, read_frac=0.4,
                                  seed=7)
    else:
        base = geometry.tiny_config()
        kw = dict(n_logical=base.n_blocks * base.slots_per_block - base.slots_per_block - 32)
        n = 2 * TINY.chunk
        tr = {"lpn": ((np.arange(n) * 5) % kw["n_logical"]).astype(np.int32).reshape(2, -1),
              "op": np.full((2, TINY.chunk), engine.OP_WRITE, np.int32)}
    cfg, j_cfg = geometry.tiny_config(**kw), j_geo.tiny_config(**kw)
    s, js = st.init_state(cfg, device=CPU), j_st.init_state(j_cfg)
    for i in range(tr["lpn"].shape[0]):
        w = tr["op"][i] == engine.OP_WRITE
        s = engine.write_path_reference(s, torch.from_numpy(tr["lpn"][i]),
                                        torch.from_numpy(w), cfg)
        js = j_eng.write_path_reference(js, jnp.asarray(tr["lpn"][i]), jnp.asarray(w), j_cfg)
        bad = compare_leaves(j_st.SSDState._fields, js, s, where=f"chunk {i}: ")
        assert not bad, "\n".join(bad)
    assert float(s.n_writes) > 0
