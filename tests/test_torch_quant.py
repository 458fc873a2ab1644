"""Parity of the port's page quantization (kvcache/quant.py and the plain
``quant_pages``) with the JAX package's ``quant_pages_ref``, at the shapes and
dtypes of tests/test_kernels.py::TestQuantPage.

Codes and scales are exact, for bf16 input too: both sides widen bf16 to f32
exactly and then take the same IEEE f32 division and round-half-to-even, so
an exact .5 tie rounds the same way in both. The error is a float mean taken
in another order: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import modes as j_modes
from repro.kernels.quant_page.ops import quant_pages as j_quant_pages
from repro.kernels.quant_page.ref import quant_pages_ref as j_quant_pages_ref
from repro.kvcache import quant as j_quant
from repro_torch.core import modes
from repro_torch.kernels.quant_page.ops import quant_pages
from repro_torch.kernels.quant_page.quant_page import quantize_pages
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

