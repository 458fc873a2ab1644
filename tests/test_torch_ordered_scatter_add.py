"""``ops.at_add_in_order`` (the observability instruments' float sums) and
its kernel's plain version on the CPU: each lane added into its row's running
value in lane order, lanes outside ``[0, N)`` dropped and negative ones
wrapped, as the JAX reference's ``.at[idx].add(src, mode="drop")`` adds them.

The CUDA kernel (``csrc/ordered_scatter_add.cu``) cannot run here; on the
card ``chip_smoke.py`` holds it bit for bit against this plain version on
the same lanes. Every case here is bit for bit: the order of the float adds
is the function, so no tolerance applies.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.kernels.ordered_scatter_add.ordered_scatter_add import (
    ordered_scatter_add, ordered_scatter_add_pair, ordered_scatter_add_pair_plain,
    ordered_scatter_add_plain)

# (rows N, trailing shape of a row, lanes L): the instruments' shapes (obs_ts
# 64 windows x 9 series, obs_lat_comp 3 modes x 64 bins by 6 components, per
# chunk of 128-1,024 reads), one lane, a 1-D destination, a wide row
SHAPES = [(64, (9,), 128), (3 * 64, (6,), 1024), (5, (3,), 1), (16, (), 300), (7, (2, 33), 64)]


def lanes(seed, n, tail, lanes_, hit_by_all=False):
    """dst, idx and src drawn by numpy: values of mixed magnitudes (so that
    the order of the adds shows in the rounding), indices with duplicates,
    drops past both ends and wrapped negatives; ``hit_by_all`` sends every
    lane to row 1."""
    rng = np.random.default_rng(seed)
    dst = (rng.standard_normal((n, *tail)) * 1e3).astype(np.float32)
    src = (rng.standard_normal((lanes_, *tail))
           * 10.0 ** rng.integers(-4, 5, (lanes_, *tail))).astype(np.float32)
    if hit_by_all:
        idx = np.ones(lanes_, np.int64)
    else:
        idx = rng.integers(-n - 2, n + 3, lanes_).astype(np.int64)
    return dst, idx, src


def serial(dst, idx, src):
    """The function by its definition: a Python loop over the lanes in order,
    each added in float32 into its row (negative indices wrapped, the rest
    outside [0, N) dropped)."""
    out = dst.copy()
    n = dst.shape[0]
    for i, v in zip(idx, src):
        i = int(i) + n if i < 0 else int(i)
        if 0 <= i < n:
            out[i] = out[i] + v  # float32 + float32, rounded once per lane
    return out


CASES = [(s, hit) for s in SHAPES for hit in (False, True)]


def _ids(case):
    (n, tail, lanes_), hit = case
    return f"{n}x{'x'.join(map(str, tail)) or '1'}_L{lanes_}" + ("_one_row" if hit else "")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lane_order_equals_a_loop_over_lanes(case):
    (n, tail, lanes_), hit = case
    dst, idx, src = lanes(lanes_, n, tail, lanes_, hit)
    got = ops.at_add_in_order(torch.from_numpy(dst), torch.from_numpy(idx),
                              torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), serial(dst, idx, src))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_matches_the_references_drop_mode_scatter_add(case):
    (n, tail, lanes_), hit = case
    dst, idx, src = lanes(lanes_ + 1, n, tail, lanes_, hit)
    want = jnp.asarray(dst).at[jnp.asarray(idx)].add(jnp.asarray(src), mode="drop")
    got = ops.at_add_in_order(torch.from_numpy(dst), torch.from_numpy(idx),
                              torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_order_is_what_the_sum_keeps():
    """Three lanes into one row whose sum depends on their order (1e8 + 1 -
    1e8 is 0 in float32, 1e8 - 1e8 + 1 is 1): the lane order's sum, and the
    inputs left as they were."""
    dst = torch.zeros(2, 1)
    idx = torch.tensor([0, 0, 0, 1, 1, 1])
    src = torch.tensor([[1e8], [1.0], [-1e8], [1e8], [-1e8], [1.0]])
    got = ops.at_add_in_order(dst, idx, src)
    assert got[:, 0].tolist() == [0.0, 1.0]
    assert dst.abs().sum() == 0


def test_broadcast_source_and_every_lane_dropped():
    """A scalar row broadcast over the lanes, and lanes that all miss."""
    dst = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    got = ops.at_add_in_order(dst, torch.tensor([2, 2, 0]), torch.tensor([0.5, 0.25]))
    np.testing.assert_array_equal(got.numpy(), [[0.5, 1.25], [2, 3], [5, 5.5]])
    got = ops.at_add_in_order(dst, torch.tensor([3, -4, 9]), torch.ones(3, 2))
    np.testing.assert_array_equal(got.numpy(), dst.numpy())


def test_plain_version_is_the_wrappers_on_the_cpu():
    dst, idx, src = (torch.from_numpy(a) for a in lanes(0, 64, (9,), 128))
    idx = torch.where(idx < 0, idx + 64, idx)
    np.testing.assert_array_equal(ordered_scatter_add(dst, idx, src).numpy(),
                                  ordered_scatter_add_plain(dst, idx, src).numpy())
    assert ordered_scatter_add.launches == 0  # the CPU never reaches the kernel


def test_wrapper_refuses_other_devices():
    dst = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ordered_scatter_add(dst, torch.zeros(3, dtype=torch.int64, device="meta"),
                            torch.zeros(3, 2, device="meta"))


# ---------------------------------------------------------------------------
# the two-segment entry: a chunk's two instruments in one launch on the card
# ---------------------------------------------------------------------------

N_MODES, N_BINS, N_COMP = 3, 64, 6  # obs_lat_comp: (mode, component, bin)


def pair_lanes(seed, lanes_, how):
    """One chunk's two segments drawn by numpy: obs_ts (64 windows x 9
    series) and obs_lat_comp in its own (mode, component, bin) layout, whose
    rows are the (mode, bin) pairs; values of mixed magnitudes. ``how``:
    "mixed" indices with duplicates and drops (past both ends, and wrapped
    negatives); "one_row" every lane of each segment to one row; "two_rows"
    each lane to one of two rows; "dropped" every lane past the end."""
    rng = np.random.default_rng(seed)
    ts = (rng.standard_normal((64, 9)) * 1e3).astype(np.float32)
    comp = (rng.standard_normal((N_MODES, N_COMP, N_BINS)) * 1e3).astype(np.float32)
    segs = []
    for dst, n, c in ((ts, 64, 9), (comp, N_MODES * N_BINS, N_COMP)):
        src = (rng.standard_normal((lanes_, c))
               * 10.0 ** rng.integers(-4, 5, (lanes_, c))).astype(np.float32)
        two = rng.integers(0, n, 2)
        idx = {"mixed": lambda: rng.integers(-n - 2, n + 3, lanes_),
               "one_row": lambda: np.full(lanes_, two[0]),
               "two_rows": lambda: two[rng.integers(0, 2, lanes_)],
               "dropped": lambda: np.full(lanes_, n)}[how]().astype(np.int64)
        segs.append((dst, idx, src))
    return segs


PAIR_CASES = [(lanes_, how) for lanes_ in (128, 1024)
              for how in ("mixed", "one_row", "two_rows", "dropped")]
PAIR_CASES += [(0, "mixed"), (1, "mixed"), (1, "dropped")]


def _pair_ids(case):
    return f"L{case[0]}_{case[1]}"


def _pair_torch(segs):
    """The pair's arguments as the instruments give them: obs_ts as it is,
    obs_lat_comp as its (mode, bin, component) view of the state's layout."""
    (ts, i_ts, s_ts), (comp, i_comp, s_comp) = segs
    return ((torch.from_numpy(ts), torch.from_numpy(i_ts), torch.from_numpy(s_ts)),
            (torch.from_numpy(comp).permute(0, 2, 1), torch.from_numpy(i_comp),
             torch.from_numpy(s_comp)))


@pytest.mark.parametrize("case", PAIR_CASES, ids=_pair_ids)
def test_pair_equals_two_single_calls(case):
    """The pair, through ``ops.at_add_in_order_pair`` and the wrapper's own
    plain version, bit for bit the two single calls on each segment's rows
    (obs_lat_comp's as a contiguous (mode * bin, component) copy), each
    result in its dst's shape and strides, the inputs left as they were."""
    lanes_, how = case
    segs = pair_lanes(lanes_ + 7, lanes_, how)
    a, b = _pair_torch(segs)
    before = [t.clone() for t in (*a, *b)]
    got = ops.at_add_in_order_pair(a, b)
    want_ts = ops.at_add_in_order(a[0], a[1], a[2])
    want_comp = ops.at_add_in_order(b[0].reshape(-1, N_COMP), b[1], b[2])
    np.testing.assert_array_equal(got[0].numpy(), want_ts.numpy())
    np.testing.assert_array_equal(got[1].reshape(-1, N_COMP).numpy(), want_comp.numpy())
    assert got[1].stride() == b[0].stride() and got[1].permute(0, 2, 1).is_contiguous()
    wrapped = [(d, torch.where(i < 0, i + d[..., 0].numel(), i), s) for d, i, s in (a, b)]
    plain = ordered_scatter_add_pair_plain(*wrapped)
    direct = ordered_scatter_add_pair(*wrapped)
    for g, p, d in zip(got, plain, direct):
        assert torch.equal(g, p) and torch.equal(g, d) and p.stride() == d.stride() == g.stride()
    for t, t0 in zip((*a, *b), before):
        assert torch.equal(t, t0)


@pytest.mark.parametrize("case", PAIR_CASES, ids=_pair_ids)
def test_pair_matches_the_references_drop_mode_scatter_adds(case):
    """The pair against JAX as the reference's record_reads adds: obs_ts by
    rows, obs_lat_comp component by component at (mode, component, bin)
    with the dropped lanes' mode past the end."""
    lanes_, how = case
    segs = pair_lanes(lanes_ + 8, lanes_, how)
    (ts, i_ts, s_ts), (comp, i_comp, s_comp) = segs
    want_ts = jnp.asarray(ts).at[jnp.asarray(i_ts)].add(jnp.asarray(s_ts), mode="drop")
    n = N_MODES * N_BINS
    cell = np.where(i_comp < 0, i_comp + n, i_comp)
    keep = (cell >= 0) & (cell < n)
    mode = np.where(keep, cell // N_BINS, N_MODES)
    bin_ = np.where(keep, cell % N_BINS, 0)
    want_comp = jnp.asarray(comp)
    for c in range(N_COMP):
        want_comp = want_comp.at[mode, c, bin_].add(jnp.asarray(s_comp[:, c]), mode="drop")
    got_ts, got_comp = ops.at_add_in_order_pair(*_pair_torch(segs))
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_array_equal(got_comp.permute(0, 2, 1).numpy(), np.asarray(want_comp))


def test_pair_takes_a_contiguous_and_a_one_row_segment():
    """Any two segments: a (N, C) contiguous one and the strided layout's
    every lane to one row, the first lane's value broadcast."""
    rng = np.random.default_rng(11)
    dst_a = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    dst_b = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)).permute(0, 2, 1)
    idx_a, idx_b = torch.tensor([4, 0, 4, 9]), torch.tensor([7, 7, 7])
    src_a = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    got_a, got_b = ops.at_add_in_order_pair((dst_a, idx_a, src_a), (dst_b, idx_b, 0.5))
    np.testing.assert_array_equal(got_a.numpy(),
                                  serial(dst_a.numpy(), idx_a.numpy(), src_a.numpy()))
    want_b = dst_b.clone()
    for _ in range(3):  # row 7 of (2 x 4) rows: group 1, row 3
        want_b[1, 3] = want_b[1, 3] + 0.5
    np.testing.assert_array_equal(got_b.numpy(), want_b.numpy())


def test_cuda_tensors_reach_the_kernel_in_one_launch(monkeypatch):
    """On CUDA tensors (mocked: fake CUDA tensors, a recording stand-in for
    the library's ctypes function) each entry makes one launch, the pair's
    carrying both segments: obs_lat_comp's strides as the state lays it out,
    the rows and columns of each, its lanes; never the plain versions."""
    import repro_torch.kernels.ordered_scatter_add.ordered_scatter_add as osa
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    def fail(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(osa, "_kernel", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(osa, "ordered_scatter_add_plain", fail)
    monkeypatch.setattr(osa, "ordered_scatter_add_pair_plain", fail)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    n0 = ordered_scatter_add.launches
    with FakeTensorMode():
        ts = torch.empty(64, 9, device="cuda")
        comp = torch.empty(N_MODES, N_COMP, N_BINS, device="cuda")
        lanes_ = torch.empty(1024, dtype=torch.int64, device="cuda")
        out_ts, out_comp = ops.at_add_in_order_pair(
            (ts, lanes_, torch.empty(1024, 9, device="cuda")),
            (comp.permute(0, 2, 1), lanes_, torch.empty(1024, N_COMP, device="cuda")))
        assert out_comp.permute(0, 2, 1).is_contiguous() and out_ts.shape == ts.shape
        ops.at_add_in_order(ts, lanes_, torch.empty(1024, 9, device="cuda"))
    assert ordered_scatter_add.launches == n0 + 2 and [c[0] for c in calls] == [2, 1]
    args = list(calls[0][1])
    # (N, C, L, rows a group, group, row and column strides) of each segment
    assert args[4:11] == [64, 9, 1024, 64, 0, 9, 1]
    assert args[15:22] == [N_MODES * N_BINS, N_COMP, 1024, N_BINS, N_COMP * N_BINS, 1, N_BINS]
    assert len(calls[1][1]) == 11 and calls[0][2] == 7
