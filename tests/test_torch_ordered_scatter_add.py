"""``ops.at_add_in_order`` (the observability instruments' float sums) and
its kernel's plain version on the CPU: each lane added into its row's running
value in lane order, lanes outside ``[0, N)`` dropped and negative ones
wrapped, as the JAX reference's ``.at[idx].add(src, mode="drop")`` adds them.

The CUDA kernel (``csrc/ordered_scatter_add.cu``) cannot run here; on the
card ``chip_smoke.py`` holds it bit for bit against this plain version on
the same lanes. Every case here is bit for bit: the order of the float adds
is the function, so no tolerance applies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.kernels.ordered_scatter_add.ordered_scatter_add import (
    ordered_scatter_add, ordered_scatter_add_plain)

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
