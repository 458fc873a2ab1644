"""Parity of the port's MoE family (``repro_torch.models.moe``; the ``moe``
entries of models/registry.py and convert.py) with the JAX package's
``repro.models.moe``, on the CPU, where attention is the plain blockwise
attention as in the reference.

Inputs: granite-moe-3b-a800m's smoke variant (d_model 128, 8 experts top-2,
expert width 64, vocab 512) cut to 2 layers, and the same with one dense
first layer (d_ff 256), one shared expert and MTP depth 1; parameters from
the reference's ``materialize`` carried over by ``convert.params_from_numpy``;
tokens and ``moe_apply``'s inputs from numpy seeds. The reference's
gradients are taken under ``jax.jit`` (a quarter of the eager time).

Tolerances, each with its reason:
- ``moe_apply`` in f32: outputs atol/rtol 1e-5, aux rtol 1e-6 (measured
  <= 6e-7 and 1e-7: the router's, the experts' and the combine's sums in
  another order). Its gradients: atol 1e-5 x the leaf's largest |g| plus rtol
  1e-5. Routing is discrete, so these hold only where both sides pick the
  same experts and drop the same assignments, which ``test_ties_and_drops``
  pins exactly.
- ``moe_apply`` in bf16 (bf16 inputs and experts, the f32 router): the
  routing is computed in f32 in both and picks the same experts; each expert
  product is rounded to bf16 once in each framework, silu at another point
  of it, so an output may sit a few bf16 ulps (2^-8 relative) apart: atol
  2e-2 x the largest |output| (measured 4.4e-3), aux rtol 1e-6.
- f32 model (loss, gradients, prefill, decode): as tests/test_torch_train.py
  and tests/test_torch_prefill.py hold the dense family: loss rtol 1e-6,
  gradients atol 1e-5 x the leaf's largest |g| plus rtol 1e-5 (measured
  3.0e-6 of the largest), logits and caches atol/rtol 1e-4 (measured 5e-6).
- bf16 parameters (the router f32) with ``dtype`` f32: the products are
  f32 of bf16 weights and the gradients are rounded to bf16, where an f32
  difference of an ulp can move an entry by one bf16 ulp: loss rtol 1e-6,
  gradients rtol 2^-7 plus atol 2^-8 x the leaf's largest |g| (measured
  <= 1.8e-3 of the largest, seeds 0-2), as tests/test_torch_train.py holds
  the dense family. With ``dtype`` bf16 too (the card's training setting)
  the residual stream is rounded to bf16 after every layer, an ulp apart in
  the two frameworks, and that moves some tokens' top-k choice where two
  experts' probabilities lie within it: a flipped choice moves that
  expert's gradients by up to 40% of their largest entry (seeds 0-2), so
  there only the loss is held, rtol 2e-3 (measured <= 3.6e-4).
- One ``make_train_step`` step against the jitted reference: loss and grad
  norm rtol 1e-5, parameters atol 1e-4 (a tenth of an lr-1e-3 step; AdamW's
  first step is steep where a gradient cancels to ~eps, as in
  tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_3b_a800m as j_granite
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import base as j_base
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.training import optim as j_optim
from repro.training import train_step as j_ts
from repro_torch import convert
from repro_torch.configs import granite_moe_3b_a800m
from repro_torch.configs.base import smoke_variant
from repro_torch.models import base, moe, registry
from repro_torch.training import optim
from repro_torch.training import train_step as ts
from test_torch_parity import to_np
from test_torch_train import assert_trees_close, batch_np, flat, to_jax, to_torch
from test_torch_transformer import by_path

KINDS = {"granite": {}, "dense_shared_mtp": dict(first_k_dense=1, n_shared_experts=1,
                                                 mtp_depth=1, d_ff=256)}


def configs(kind="granite", **kw):
    kw = dict(n_layers=2, **KINDS[kind], **kw)
    return (j_smoke_variant(j_granite.CONFIG).with_(**kw),
            smoke_variant(granite_moe_3b_a800m.CONFIG).with_(**kw))


def params_pair(cj, ct, dtype=jnp.float32, seed=0):
    """The reference's parameters (``dtype``; None keeps the specs' own: bf16,
    the router f32) and the port's copy."""
    pj = j_base.materialize(j_registry.get_api(cj).specs(), jax.random.PRNGKey(seed), dtype)
    return pj, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def moe_inputs(cfg, dtype, seed=3, b=2, s=16, x=None):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
         "w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(dtype),
         "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(dtype),
         "w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(dtype)}
    if x is None:
        x = rng.standard_normal((b, s, d)).astype(dtype)
    return p, x


def to_port(tree):
    return {k: convert.tensor_from_numpy(v, "cpu") for k, v in tree.items()}


def loads(cfg, x, p):
    """Assignments per expert, by the reference's routing (numpy)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x, jnp.float32).reshape(-1, cfg.d_model)
                                      @ p["router"], axis=-1))
    idx = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    return np.bincount(idx.reshape(-1), minlength=cfg.n_experts)


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(dtype, capacity_factor):
    _, ct = configs(capacity_factor=capacity_factor)
    cj = configs(capacity_factor=capacity_factor)[0]
    p, x = moe_inputs(ct, jnp.dtype(dtype))
    cap = moe.capacity(ct, x.shape[0] * x.shape[1])
    assert cap == j_moe.capacity(cj, x.shape[0] * x.shape[1])
    dropped = loads(ct, x, p).max() > cap
    assert dropped == (capacity_factor == 0.5)
    yj, aj = j_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cj)
    yt, at = moe.moe_apply(to_port(p), convert.tensor_from_numpy(x, "cpu"), ct)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == x.shape and at.dtype == torch.float32
    big = float(np.abs(to_np(yj)).max())
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (2e-2 * big, 0)
    np.testing.assert_allclose(to_np(yt), to_np(yj), atol=atol, rtol=rtol)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    if dtype == "bfloat16":
        return
    # gradients through the capacity drop, the combine and the aux loss
    pj = {k: jnp.asarray(v) for k, v in p.items()}

    def j_fn(p_, x_):
        y, a = j_moe.moe_apply(p_, x_, cj)
        return jnp.sum(y * jnp.cos(y)) + a

    gj = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(pj, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in to_port(p).items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y, a = moe.moe_apply(leaves, xt, ct)
    gt = torch.autograd.grad(torch.sum(y * torch.cos(y)) + a, [*leaves.values(), xt])
    for name, g_t, g_j in zip([*leaves, "x"], gt, [*(gj[0][k] for k in leaves), gj[1]]):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(to_np(g_t), g_j, rtol=1e-5, atol=1e-5 * np.abs(g_j).max(),
                                   err_msg=name)


def test_ties_and_drops():
    """Equal probabilities pick the lower expert (lax.top_k), and a full
    expert keeps its first assignments in token order (the stable argsort):
    three token rows repeated 48 times under a router whose probabilities tie
    at the top-k boundary, at a capacity that drops many of them. torch.topk
    (its CPU order already differs here) and an unstable sort are free to
    choose otherwise; the port must keep exactly the reference's tokens."""
    _, ct = configs(capacity_factor=0.5)
    cj = configs(capacity_factor=0.5)[0]
    p, _ = moe_inputs(ct, np.float32)
    rng = np.random.default_rng(9)
    u = rng.standard_normal(ct.d_model).astype(np.float32)
    # logits (2a, a, a, 0, ..., 0) with a = x.u: where a > 0 experts 1 and 2 tie
    # for the second place, where a < 0 experts 3 to 7 tie for both places
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0], p["router"][:, 1], p["router"][:, 2] = 2 * u, u, u
    rows = rng.standard_normal((3, ct.d_model)).astype(np.float32)
    x = rows[rng.integers(0, 3, 48)].reshape(3, 16, ct.d_model)  # each row many times
    yj, aj = j_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cj)
    yt, at = moe.moe_apply(to_port(p), torch.from_numpy(x), ct)
    yj = np.asarray(yj)
    # some copies of a row are dropped by an expert and others not: the kept set shows
    assert len({tuple(np.round(r, 4)) for r in yj.reshape(-1, ct.d_model)}) > 3
    np.testing.assert_allclose(to_np(yt), yj, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: loss and gradients, prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,remat", [("granite", False), ("granite", True),
                                        ("dense_shared_mtp", True)])
def test_loss_and_grads_match_reference(kind, remat):
    cj, ct = configs(kind, remat=remat)
    pj, pt = params_pair(cj, ct)
    batch = batch_np(ct)
    lj, gj = jax.jit(jax.value_and_grad(j_registry.get_api(cj).loss_fn))(pj, to_jax(batch))
    lt, gt = ts.value_and_grad(registry.get_api(ct).loss_fn, pt, to_torch(batch))
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_trees_close(gt, gj, rtol=1e-5, atol_of_max=1e-5, what="grad")
    # the aux loss reaches the total: the hidden states and aux are the reference's
    (hj, aj), (ht, at) = j_moe.forward(pj, to_jax(batch), cj), moe.forward(pt, to_torch(batch), ct)
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    assert float(at) > 0


def test_bf16_loss_and_grads_match_reference():
    """bf16 parameters (the router f32), as ``materialize`` makes them without
    a dtype: with ``dtype`` f32 the loss and every gradient; with ``dtype``
    bf16, the card's training setting, the loss."""
    cj, ct = configs()
    pj, pt = params_pair(cj, ct, dtype=None)
    assert pt["moe_layers"][0]["moe"]["router"].dtype == torch.float32
    assert pt["moe_layers"][0]["moe"]["w_in"].dtype == torch.bfloat16
    batch = batch_np(ct)
    lj, gj = jax.jit(jax.value_and_grad(j_registry.get_api(cj).loss_fn))(pj, to_jax(batch))
    lt, gt = ts.value_and_grad(registry.get_api(ct).loss_fn, pt, to_torch(batch))
    assert all(g.dtype == p.dtype for g, p in zip(base.tree_leaves(gt), base.tree_leaves(pt)))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_trees_close(gt, gj, rtol=2**-7, atol_of_max=2**-8, what="grad")
    cj, ct = cj.with_(dtype=jnp.bfloat16), ct.with_(dtype=torch.bfloat16)
    lj = jax.jit(j_registry.get_api(cj).loss_fn)(pj, to_jax(batch))
    lt = registry.get_api(ct).loss_fn(pt, to_torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)


@pytest.mark.parametrize("kind", list(KINDS))
def test_prefill_then_decode_matches_reference(kind):
    """make_prefill's logits and cache, then 4 greedy decode steps from the
    cache lengthened by 4 zero positions, each step's logits and cache."""
    cj, ct = configs(kind)
    pj, pt = params_pair(cj, ct)
    b, s, steps = 3, 12, 4
    tok = np.random.default_rng(7).integers(0, ct.vocab, (b, s)).astype(np.int32)
    lj, cache_j = j_moe.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    lt, cache_t = registry.get_api(ct).prefill(pt, {"tokens": torch.from_numpy(tok)})
    want = {"moe_k", "moe_v"} | ({"dense_k", "dense_v"} if ct.first_k_dense else set())
    assert set(cache_t) == set(cache_j) == want
    specs = registry.get_api(ct).init_cache_specs(b, s)
    jspecs = j_registry.get_api(cj).init_cache_specs(b, s)
    for name, c in cache_t.items():
        assert tuple(c.shape) == specs[name].shape == jspecs[name].shape, name
        np.testing.assert_allclose(to_np(c), np.asarray(cache_j[name]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
    pad = {n: np.concatenate([np.asarray(c), np.zeros_like(np.asarray(c)[:, :, :steps])], 2)
           for n, c in cache_j.items()}
    cache_j, cache_t = pad, convert.cache_from_numpy(pad, "cpu")
    nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), s + t, np.int32)
        lj, cache_j = j_moe.decode_step(pj, cache_j, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
                                        cj)
        lt, cache_t = registry.get_api(ct).decode_step(pt, cache_t, torch.from_numpy(nxt[:, None]),
                                                       torch.from_numpy(pos))
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=1e-4, rtol=1e-4)
        for name in cache_j:
            np.testing.assert_allclose(to_np(cache_t[name]), np.asarray(cache_j[name]),
                                       atol=1e-4, rtol=1e-4, err_msg=f"step {t} {name}")
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        assert np.array_equal(to_np(torch.argmax(lt[:, -1], -1)), nxt)


# ---------------------------------------------------------------------------
# convert, specs, train step
# ---------------------------------------------------------------------------
def test_convert_round_trip_and_specs():
    """Parameters and AdamW moments cross both ways, the layer groups
    (``moe_layers``, ``dense_layers``) stacked in the reference and listed
    in the port, ``mtp`` as it is; the port's specs are the reference's."""
    cj, ct = configs("dense_shared_mtp")
    pj, pt = params_pair(cj, ct, dtype=None)
    assert len(pt["moe_layers"]) == 1 and len(pt["dense_layers"]) == 1
    assert isinstance(pt["mtp"]["block"], dict)
    back, want = flat(convert.params_to_numpy(pt)), flat(pj)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    sj, st = j_moe.specs(cj), moe.specs(ct)
    assert base.n_params(st) == j_base.n_params(sj)
    for group in ("moe_layers", "dense_layers"):  # one spec tree per layer, stacked there
        lj, lt = by_path(sj[group]), by_path(st[group][0])
        assert lj.keys() == lt.keys()
        for k, s in lj.items():
            assert (s.shape[1:], s.axes[1:], s.init) == (lt[k].shape, lt[k].axes, lt[k].init), k
    mj, mt = by_path(sj["mtp"]), by_path(st["mtp"])
    assert {k: (s.shape, s.init) for k, s in mj.items()} == {k: (s.shape, s.init)
                                                            for k, s in mt.items()}
    assert st["moe_layers"][0]["moe"]["router"].dtype == torch.float32
    assert st["moe_layers"][0]["moe"]["w_in"].dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    mv = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pj)
          for _ in range(2)]
    st = convert.opt_state_from_numpy((*mv, np.int32(3)), ct, "cpu")
    on = convert.opt_state_to_numpy(st)
    for got, ref in ((on.m, mv[0]), (on.v, mv[1])):
        assert flat(got).keys() == flat(ref).keys()
        for k, a in flat(ref).items():
            np.testing.assert_array_equal(flat(got)[k], a, err_msg=k)
    back = convert.unstack_layers(convert.stack_layers((pt, st)), convert.layer_depths(ct))
    for a, b in zip(base.tree_leaves((pt, st)), base.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                  ct.with_(first_k_dense=0), "cpu")


def test_train_step_matches_jitted_reference():
    cj, ct = configs()
    pj, pt = params_pair(cj, ct)
    ocfg_kw = dict(lr=1e-3, warmup=2, total_steps=10)
    j_step = jax.jit(j_ts.make_train_step(cj, j_optim.AdamWConfig(**ocfg_kw)))
    t_step = ts.make_train_step(ct, optim.AdamWConfig(**ocfg_kw))
    batch = batch_np(ct, seed=10, b=4)
    pj, js, jm = j_step(pj, j_optim.init(pj), to_jax(batch))
    pt, tst, tm = t_step(pt, optim.init(pt), to_torch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    got, want = flat(convert.params_to_numpy(pt)), flat(pj)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert_trees_close(tst.m, js.m, rtol=1e-4, atol_of_max=1e-4, what="m")
