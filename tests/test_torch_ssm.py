"""Parity of the port's recurrent mixers (``repro_torch.models.ssm``: the
causal depthwise conv, mLSTM, sLSTM and Mamba2) with the JAX package's
``repro.models.ssm``, on the CPU.

Inputs: xlstm-125m's smoke variant (d_model 128, 4 heads, expand 2, d_conv
4) for mLSTM and sLSTM, zamba2-2.7b's (d_state 16, 4 Mamba2 heads of 64)
for Mamba2; parameters from the reference's ``materialize``, activations
from numpy seeds. A carried state is the reference's own state after a
first chunk of other tokens, so that the stabilizers and normalizers hold
the values a real prompt leaves.

Tolerances, each with its reason:
- f32: every output and state leaf within 1e-5 x the leaf's largest |value|
  plus 1e-5 relative (one f32 function; the port's softplus, exp and
  products round an ulp apart from XLA's; measured <= 1.1e-6 of the
  largest).
- bf16 (bf16 inputs and weights; the gates' weights, the states and the
  recurrences in f32, as the specs give them): the projections and the
  group norm round to bf16 at the points the reference does, but XLA on the
  CPU may keep a fused chain in f32 where the port rounds each op: outputs
  and states within 2e-2 x the leaf's largest |value| (a few bf16 ulps,
  2^-8 each; measured <= 1.3e-2, mLSTM's output), as
  tests/test_torch_moe.py holds bf16 experts.
- The chained single-token steps against one call over the same tokens: the
  same function, the products over 1 row instead of 8: 1e-5 as f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_125m as j_xlstm_cfg
from repro.configs import zamba2_2_7b as j_zamba_cfg
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import base as j_base
from repro.models import ssm as j_ssm
from repro_torch import convert
from repro_torch.configs import xlstm_125m, zamba2_2_7b
from repro_torch.configs.base import smoke_variant
from repro_torch.models import ssm
from test_torch_parity import to_np

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# block -> (reference config module, port config module, spec, state spec, apply)
BLOCKS = {
    "mlstm": (j_xlstm_cfg, xlstm_125m, "mlstm_specs", "mlstm_state_specs", "mlstm_apply"),
    "slstm": (j_xlstm_cfg, xlstm_125m, "slstm_specs", "slstm_state_specs", "slstm_apply"),
    "mamba2": (j_zamba_cfg, zamba2_2_7b, "mamba2_specs", "mamba2_state_specs", "mamba2_apply"),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def to_port(tree):
    """A tree of JAX arrays (dicts) as the port's CPU tensors, dtypes kept."""
    return convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def dtype_name(x):
    """"float32", "bfloat16", ... of a tensor or a JAX array."""
    return str(x.dtype).removeprefix("torch.")


def assert_close(got, want, tol, what):
    """Leaf by leaf (dicts): |got - want| <= tol * max|want| + tol * |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            assert_close(got[k], want[k], tol, f"{what}.{k}")
        return
    w, g = to_np(want), to_np(got)
    assert g.shape == w.shape and dtype_name(got) == dtype_name(want), (
        what, g.shape, w.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * float(np.abs(w).max()), err_msg=what)


def setup(block, dtype, seed=0):
    """(reference config, port config, reference params, port params,
    reference apply, port apply) of one block at its smoke widths."""
    j_mod, t_mod, spec, _, apply = BLOCKS[block]
    cj = j_smoke_variant(j_mod.CONFIG).with_(dtype=jnp.dtype(dtype))
    ct = smoke_variant(t_mod.CONFIG).with_(dtype=TORCH_DT[dtype])
    # f32: every leaf f32; bf16: the specs' own dtypes (bf16, the gates and
    # the recurrences' parameters f32)
    pj = j_base.materialize(getattr(j_ssm, spec)(cj), jax.random.PRNGKey(seed),
                            jnp.float32 if dtype == "float32" else None)
    return cj, ct, pj, to_port(pj), getattr(j_ssm, apply), getattr(ssm, apply)


def inputs(cfg, dtype, seed, b=2, s=8):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_reference(k, with_state):
    rng = np.random.default_rng(3 + k)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((k, 12)).astype(np.float32)
    st = rng.standard_normal((2, k - 1, 12)).astype(np.float32) if with_state else None
    yj, sj = j_ssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                          None if st is None else jnp.asarray(st))
    yt, stt = ssm._causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                         None if st is None else torch.from_numpy(st))
    assert tuple(stt.shape) == sj.shape == (2, k - 1, 12)
    np.testing.assert_allclose(to_np(yt), np.asarray(yj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_np(stt), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_apply_matches_reference(block, dtype):
    """From the zero state, then from the reference's state after it (a
    carried state): the output and every leaf of the new state."""
    cj, ct, pj, pt, j_apply, t_apply = setup(block, dtype)
    x1, x2 = inputs(cj, dtype, seed=1), inputs(cj, dtype, seed=2, s=5)
    yj, sj = j_apply(pj, x1, cj)
    yt, st = t_apply(pt, to_port({"x": x1})["x"], ct)
    assert_close(yt, yj, TOL[dtype], f"{block} y")
    assert_close(st, sj, TOL[dtype], f"{block} state")
    spec = getattr(j_ssm, BLOCKS[block][3])(cj, 2)
    assert {k: (v.shape, jnp.dtype(v.dtype)) for k, v in sj.items()} == {
        k: (s.shape, jnp.dtype(s.dtype)) for k, s in spec.items()}
    tspec = getattr(ssm, BLOCKS[block][3])(ct, 2)
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == {
        k: (s.shape, s.dtype) for k, s in tspec.items()}
    # from the carried state
    yj, sj2 = j_apply(pj, x2, cj, sj)
    yt, st2 = t_apply(pt, to_port({"x": x2})["x"], ct, to_port(sj))
    assert_close(yt, yj, TOL[dtype], f"{block} y (carried)")
    assert_close(st2, sj2, TOL[dtype], f"{block} state (carried)")


@pytest.mark.parametrize("block", list(BLOCKS))
def test_eight_single_steps_equal_one_call(block):
    """Eight decode-style calls of one token, each from the last one's state,
    give the outputs and the state of one call over the eight tokens (and
    the reference's), from a carried state."""
    cj, ct, pj, pt, j_apply, t_apply = setup(block, "float32")
    _, s0 = j_apply(pj, inputs(cj, "float32", seed=4, s=6), cj)
    x = inputs(cj, "float32", seed=5, s=8)
    yj, sj = j_apply(pj, x, cj, s0)
    xt = to_port({"x": x})["x"]
    y_all, s_all = t_apply(pt, xt, ct, to_port(s0))
    st, ys = to_port(s0), []
    for t in range(8):
        y, st = t_apply(pt, xt[:, t:t + 1], ct, st)
        ys.append(y)
    y_chain = torch.cat(ys, dim=1)
    assert_close(y_chain, y_all, 1e-5, f"{block} chained y")
    assert_close(st, s_all, 1e-5, f"{block} chained state")
    assert_close(y_chain, yj, 1e-5, f"{block} chained y against the reference")
    assert_close(st, sj, 1e-5, f"{block} chained state against the reference")


def test_softplus_is_logaddexp():
    """``_softplus`` is jax.nn.softplus's logaddexp(x, 0) (not F.softplus's
    thresholded log1p(exp(x))): within an f32 ulp of the reference's across
    the range the gates meet, 0 beyond it."""
    x = np.linspace(-60, 60, 24001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = to_np(ssm._softplus(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert (got[x < -30] > 0).all()  # no underflow to 0 where the reference has none


def test_group_norm_is_the_population_variance():
    """The group norm divides by the population variance (``jnp.var``), not
    torch.var's default unbiased one: a head of 64 channels would differ by
    sqrt(64 / 63)."""
    y = np.random.default_rng(6).standard_normal((2, 3, 256)).astype(np.float32)
    got = to_np(ssm._group_norm(torch.from_numpy(y), 4))
    yh = y.reshape(2, 3, 4, 64)
    want = ((yh - yh.mean(-1, keepdims=True)) / np.sqrt(yh.var(-1, keepdims=True) + 1e-6))
    np.testing.assert_allclose(got, want.reshape(2, 3, 256), rtol=1e-5, atol=1e-5)
