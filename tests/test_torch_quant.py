"""Parity of the port's page quantization (kvcache/quant.py and the plain
``quant_pages``) with the JAX package's ``quant_pages_ref``, at the shapes and
dtypes of tests/test_kernels.py::TestQuantPage; and the plain version of the
kernel's store entry (``quant_store_pages``) against quantizing with
``quant_pages`` and writing the kept lanes with masked ``index_put``s.

Codes and scales are exact, for bf16 input too: both sides widen bf16 to f32
exactly and then take the same IEEE f32 division and round-half-to-even, so
an exact .5 tie rounds the same way in both. The error is a float mean taken
in another order: rtol 1e-5. Stored pools are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import modes as j_modes
from repro.kernels.quant_page.ops import quant_pages as j_quant_pages
from repro.kernels.quant_page.ref import quant_pages_ref as j_quant_pages_ref
from repro.kvcache import quant as j_quant
from repro_torch.core import modes
from repro_torch.kernels.quant_page import quant_page as qp
from repro_torch.kernels.quant_page.ops import quant_pages, quant_store_pages
from repro_torch.kernels.quant_page.quant_page import quantize_pages
from repro_torch.kernels.quant_page.ref import scatter_drop
from repro_torch.kvcache import quant
from test_torch_parity import to_np

SHAPES = [(4, 16, 4, 32), (2, 64, 2, 128), (1, 8, 8, 64)]


def _pages(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    # a few exact .5 ties (x / scale lands on k + 0.5) and an all-zero head
    x.reshape(-1)[:4] = [0.5, -1.5, 2.5, -3.5]
    x[0, :, -1, :] = 0.0
    xj = jnp.asarray(x, dtype)
    return xj, torch.tensor(to_np(xj)).to(getattr(torch, jnp.dtype(dtype).name))


@pytest.mark.parametrize("tier", [modes.TIER_INT8, modes.TIER_INT4])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_quant_pages_matches_reference(tier, shape, dtype):
    xj, xt = _pages(shape, dtype)
    q_r, s_r, e_r = j_quant_pages_ref(xj, tier=tier)
    q, s, e = quant_pages(xt, tier=tier)
    assert q.dtype == torch.int8 and q.shape == tuple(q_r.shape)
    np.testing.assert_array_equal(to_np(q), np.asarray(q_r))
    np.testing.assert_array_equal(to_np(s), np.asarray(s_r))
    np.testing.assert_allclose(to_np(e), np.asarray(e_r), rtol=1e-5)
    # the wrapper keeps the kernel's (N, 1) error and counts no launch on the CPU
    n0 = quantize_pages.launches
    assert quantize_pages(xt, tier=tier)[2].shape == (shape[0], 1)
    assert quantize_pages.launches == n0


@pytest.mark.parametrize("tier", [modes.TIER_INT8, modes.TIER_INT4])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(tier):
    xj, xt = _pages((4, 16, 4, 32), jnp.float32, seed=3)
    q_k, s_k, e_k = j_quant_pages(xj, tier=tier)
    q, s, e = quant_pages(xt, tier=tier)
    if tier == modes.TIER_INT4:
        q_k, q = j_quant.unpack_int4(q_k), quant.unpack_int4(q)
    # the tolerance tests/test_kernels.py sets between the kernel and its oracle
    dq = np.abs(to_np(q).astype(np.int32) - np.asarray(q_k, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 0.01
    np.testing.assert_allclose(to_np(s), np.asarray(s_k), rtol=1e-6)
    np.testing.assert_allclose(to_np(e), np.asarray(e_k), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quant_module_functions(dtype):
    xj, xt = _pages((3, 8, 2, 16), dtype, seed=1)
    for jf, tf in ((j_quant.quantize_int8, quant.quantize_int8),
                   (j_quant.quantize_int4, quant.quantize_int4)):
        (qj, sj), (qt, st) = jf(xj), tf(xt)
        np.testing.assert_array_equal(to_np(qt), np.asarray(qj))
        np.testing.assert_array_equal(to_np(st), np.asarray(sj))
    q8, s8 = quant.quantize_int8(xt)
    q4, s4 = quant.quantize_int4(xt)
    for out_dt, j_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            to_np(quant.dequantize_int8(q8, s8, out_dt)),
            to_np(j_quant.dequantize_int8(jnp.asarray(to_np(q8)), jnp.asarray(to_np(s8)), j_dt)))
        np.testing.assert_array_equal(
            to_np(quant.dequantize_int4(q4, s4, out_dt)),
            to_np(j_quant.dequantize_int4(jnp.asarray(to_np(q4)), jnp.asarray(to_np(s4)), j_dt)))
    for tier in (j_modes.TIER_BF16, j_modes.TIER_INT8, j_modes.TIER_INT4):
        np.testing.assert_allclose(to_np(quant.quant_error(xt, tier)),
                                   np.asarray(j_quant.quant_error(xj, tier)), rtol=1e-5)


def test_pack_unpack_int4_all_codes():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (5, 3, 2, 16)).astype(np.int8)
    codes.reshape(-1)[:16] = np.arange(-8, 8)
    packed = quant.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(to_np(packed), np.asarray(j_quant.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(to_np(quant.unpack_int4(packed)), codes)


def test_error_ordering():
    # int4 must be lossier than int8 — the RBER ordering of the tiers
    _, xt = _pages((4, 16, 4, 32), jnp.float32, seed=1)
    e8 = quant_pages(xt, tier=modes.TIER_INT8)[2]
    e4 = quant_pages(xt, tier=modes.TIER_INT4)[2]
    assert (e4 > e8).all()


def test_rejects_tier_zero():
    with pytest.raises(ValueError):
        quantize_pages(torch.zeros(1, 2, 1, 4), tier=modes.TIER_BF16)



def _store_by_masks(pools, tier_id, slots, kpage, vpage):
    """The store as the port wrote it before the store entry: quantize every
    lane with ``quant_pages``, then write the lanes with slot >= 0 through
    boolean masks and out-of-place ``index_put``s."""
    (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4) = pools
    ok = slots >= 0
    idx = slots[ok].long()
    if tier_id == modes.TIER_BF16:
        k16 = k16.index_put((idx,), kpage[ok].to(k16.dtype))
        v16 = v16.index_put((idx,), vpage[ok].to(v16.dtype))
        return (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4)
    b = kpage.shape[0]
    q, s, _ = quant_pages(torch.cat([kpage, vpage]), tier=tier_id)
    qk, qv, sk, sv = q[:b][ok], q[b:][ok], s[:b][ok], s[b:][ok]
    if tier_id == modes.TIER_INT8:
        k8, v8 = k8.index_put((idx,), qk), v8.index_put((idx,), qv)
        sk8, sv8 = sk8.index_put((idx,), sk), sv8.index_put((idx,), sv)
    else:
        k4, v4 = k4.index_put((idx,), qk), v4.index_put((idx,), qv)
        sk4, sv4 = sk4.index_put((idx,), sk), sv4.index_put((idx,), sv)
    return (k16, v16, k8, v8, sk8, sv8, k4, v4, sk4, sv4)


def _store_case(shape, page_dtype, pool0_dtype, seed, n=(5, 6, 9)):
    """Random pages, random pools (so that an untouched slot shows), and lanes
    over tiers 0/1/2 with distinct slots, some of them skipped (slot -1, or
    one past the pool's end)."""
    rng = np.random.default_rng(seed)
    b, p, hk, d = shape
    pages = [torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(page_dtype)
             for _ in range(2)]
    pages[0].view(-1)[:4] = torch.tensor([0.5, -1.5, 2.5, -3.5])  # exact .5 ties

    def codes(rows, width):
        return torch.tensor(rng.integers(-128, 128, (rows, p, hk, width)).astype(np.int8))

    def scales(rows):
        return torch.tensor(rng.random((rows, hk)).astype(np.float32))

    pools = (*[torch.tensor(rng.standard_normal((n[0], p, hk, d)).astype(np.float32))
               .to(pool0_dtype) for _ in range(2)],
             codes(n[1], d), codes(n[1], d), scales(n[1]), scales(n[1]),
             codes(n[2], d // 2), codes(n[2], d // 2), scales(n[2]), scales(n[2]))
    tier = rng.integers(0, 3, b).astype(np.int32)
    slot = np.array([rng.permutation(n[t])[i] for i, t in enumerate(tier)], np.int32)
    skipped = rng.random(b) < 0.3
    skipped[0] = True
    slot[skipped] = -1
    slot[-1] = n[tier[-1]]  # beyond the pool: skipped too
    return pages, torch.tensor(tier), torch.tensor(slot), pools


STORE_SHAPES = [(4, 8, 4, 64), (4, 16, 4, 32), (2, 64, 2, 128), (1, 8, 8, 64)]


@pytest.mark.parametrize("pool0_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STORE_SHAPES)
def test_plain_store_matches_quantize_then_masked_index_put(shape, page_dtype, pool0_dtype):
    """One plain store of lanes mixed over the tiers equals, for every pool
    tensor and every slot (untouched ones included), storing each tier's lanes
    by quantizing and writing through boolean masks; the given pools are left
    as they were."""
    (kpage, vpage), tier, slot, pools = _store_case(shape, page_dtype, pool0_dtype,
                                                    seed=sum(shape))
    before = [t.clone() for t in pools]
    out = quant_store_pages(kpage, vpage, tier, slot, pools)
    want = pools
    for t in range(3):
        n = pools[(0, 2, 6)[t]].shape[0]
        keep = (tier == t) & (slot >= 0) & (slot < n)
        want = _store_by_masks(want, t, torch.where(keep, slot, -1), kpage, vpage)
    for i, (a, w, old) in enumerate(zip(out, want, before)):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        assert torch.equal(a, w), f"pool {i}"
        assert torch.equal(pools[i], old), f"pool {i} was written in place"


@pytest.mark.parametrize("tiers", [(1,), (2,), (0, 2)])
def test_plain_store_leaves_tiers_not_named_alone(tiers):
    """Lanes of a tier outside ``tiers`` are skipped, and its pools come back
    as the very tensors that were given."""
    (kpage, vpage), tier, slot, pools = _store_case((6, 8, 2, 16), torch.float32,
                                                    torch.float32, seed=4)
    tier = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    slot = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    out = quant_store_pages(kpage, vpage, tier, slot, pools, tiers=tiers)
    want = pools
    for t in tiers:
        want = _store_by_masks(want, t, torch.where(tier == t, slot, -1), kpage, vpage)
    for i, (a, w) in enumerate(zip(out, want)):
        assert torch.equal(a, w), f"pool {i}"
        if not any(i in qp.POOL_INDEX[t] for t in tiers):
            assert a is pools[i]


def test_scatter_drop_is_the_reference_drop_mode_set():
    rng = np.random.default_rng(2)
    dst = rng.standard_normal((6, 3)).astype(np.float32)
    idx = np.array([4, 6, 0, 6, 2], np.int64)  # 6 = n: dropped, twice
    src = rng.standard_normal((5, 3)).astype(np.float32)
    ref = jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(src), mode="drop")
    out = scatter_drop(torch.tensor(dst), torch.tensor(idx), torch.tensor(src))
    assert out.shape == dst.shape
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    flags = scatter_drop(torch.ones(4, dtype=torch.bool), torch.tensor([1, 4, 3]), False)
    assert flags.tolist() == [True, False, True, False]


def test_cuda_tensors_reach_the_store_kernel(monkeypatch):
    """On CUDA tensors the store entry launches the kernel (mocked here: fake
    CUDA tensors, a recording stand-in for the ctypes function) with every
    pointer, the shapes, the pools' sizes and dtypes and the tiers it may
    write, never the plain version; it hands back new tensors for those tiers
    and the given ones for the rest, and counts one launch per call. An odd
    head dim is refused before any launch."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        return 0

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(qp, "_kernel", lambda name="quant_pages_launch": fake_launch)
    monkeypatch.setattr(qp, "quant_store_pages_ref", no_plain)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 9}))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = quantize_pages.launches
    b, p, hk, d, n = 3, 8, 4, 64, (5, 6, 9)
    with FakeTensorMode():
        def empty(shape, dt=torch.float32):
            return torch.empty(shape, dtype=dt, device="cuda")

        kpage, vpage = empty((b, p, hk, d), torch.bfloat16), empty((b, p, hk, d), torch.bfloat16)
        tier, slot = empty((b,), torch.int32), empty((b,), torch.int32)
        pools = (empty((n[0], p, hk, d)), empty((n[0], p, hk, d)),
                 empty((n[1], p, hk, d), torch.int8), empty((n[1], p, hk, d), torch.int8),
                 empty((n[1], hk)), empty((n[1], hk)),
                 empty((n[2], p, hk, d // 2), torch.int8),
                 empty((n[2], p, hk, d // 2), torch.int8),
                 empty((n[2], hk)), empty((n[2], hk)))
        out = quant_store_pages(kpage, vpage, tier, slot, pools)
        assert all(o is not g and o.device.type == "cuda" and o.shape == g.shape
                   for o, g in zip(out, pools))
        out = quant_store_pages(kpage, vpage, tier, slot, pools, tiers=(2,))
        assert [o is g for o, g in zip(out, pools)] == [True] * 6 + [False] * 4
        none = empty((0, p, hk, d), torch.bfloat16)
        no_lanes = empty((0,), torch.int32)
        assert quant_store_pages(none, none, no_lanes, no_lanes, pools)[0] is not pools[0]
        odd = empty((b, p, hk, 5))
        with pytest.raises(ValueError, match="even head dim"):
            quant_store_pages(odd, odd, tier, slot, pools)
        with pytest.raises(ValueError, match="pool 2"):
            quant_store_pages(kpage, vpage, tier, slot, (*pools[:2], pools[6], *pools[3:]))
    assert quantize_pages.launches == before + 2 and len(calls) == 2
    for args, allowed in zip(calls, (0b111, 0b100)):
        ptrs, ints, stream = args[:14], args[14:24], args[24]
        assert all(isinstance(x, int) for x in ptrs) and stream == 9
        assert list(ints) == [b, p, hk, d, *n, 1, 0, allowed]
