"""Shared checks of the port's model families against the JAX package's on
the CPU (tests/test_torch_{xlstm,hybrid,encdec}.py): parameters drawn by
the reference and carried over, a numpy-seeded batch, the loss and every
gradient leaf, prefill then greedy decode steps with every cache leaf, and
the specs and the converters' round trip.

Tolerances (f32): the loss 1e-5 relative; gradients, logits and every
cache leaf within 1e-5 x the leaf's largest |value| plus 1e-5 relative
(one f32 function summed in another order; each test file states what it
measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import base as j_base
from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch.models import base, registry
from repro_torch.training import train_step as ts
from test_torch_parity import to_np
from test_torch_train import flat

TOL = 1e-5


def params_pair(cj, ct, dtype=jnp.float32, seed=0):
    """The reference's parameters (``dtype``; None keeps the specs' own) and
    the port's copy."""
    pj = j_base.materialize(j_registry.get_api(cj).specs(), jax.random.PRNGKey(seed), dtype)
    return pj, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")


def batch_np(cfg, seed=1, b=2, s=16, labels=True):
    """Tokens (and labels, three of them ignored), and for ``encdec`` the
    frames, all from one numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        lab[:, :3] = -1
        out["labels"] = lab
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def assert_cache_close(got, want, tol=TOL, what="cache"):
    """Every leaf of a (nested) cache: the same keys, shapes and dtypes, and
    values within tol x the leaf's largest |value| plus tol relative."""
    g, w = base.tree_paths(got), base.tree_paths(want)
    assert g.keys() == w.keys(), (what, set(g) ^ set(w))
    for k in w:
        gk, wk = to_np(g[k]), to_np(w[k])
        assert gk.shape == wk.shape and str(g[k].dtype).removeprefix("torch.") == str(
            w[k].dtype), (what, k, g[k].dtype, w[k].dtype)
        np.testing.assert_allclose(gk, wk, rtol=tol, atol=tol * float(np.abs(wk).max()),
                                   err_msg=f"{what} {k}")


def check_loss_and_grads(cj, ct, batch, seed=0, grad_atol_of_max=TOL, leaf_atol_of_max=None):
    """The loss (rtol TOL) and every gradient leaf (rtol TOL, atol
    ``grad_atol_of_max`` x the leaf's largest |value|, or for a leaf named
    in ``leaf_atol_of_max`` its own) against the jitted
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    pj, pt = params_pair(cj, ct, seed=seed)
    lj, gj = jax.jit(jax.value_and_grad(j_registry.get_api(cj).loss_fn))(pj, to_jax(batch))
    api = registry.get_api(ct)
    lt, gt = ts.value_and_grad(api.loss_fn, pt, to_torch(batch), api.idle_params)
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    got = flat(base.tree_map(convert.tensor_to_numpy, convert.stack_layers(gt)))
    want = flat(gj)
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        atol = (leaf_atol_of_max or {}).get(k, grad_atol_of_max) * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=atol, err_msg=f"grad {k}")
    return float(lt)


def check_prefill_then_decode(cj, ct, batch, steps=4, pad=()):
    """make_prefill's logits and cache, then ``steps`` greedy decode steps,
    each step's logits and every cache leaf. The cache entries named in
    ``pad`` (the self-attention K and V) are lengthened by ``steps`` zero
    positions first (axis 2), so that the steps follow the prompt."""
    pj, pt = params_pair(cj, ct)
    b, s = batch["tokens"].shape
    lj, cache_j = j_registry.get_api(cj).prefill(pj, to_jax(batch))
    lt, cache_t = registry.get_api(ct).prefill(pt, to_torch(batch))
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(lj)).max()))
    assert_cache_close(cache_t, cache_j, what="prefill cache")
    spec_t = registry.get_api(ct).init_cache_specs(b, s)
    assert {k: v.shape for k, v in base.tree_paths(cache_t).items()} == {
        k: torch.Size(v.shape) for k, v in base.tree_paths(spec_t).items()}
    cache_j = {k: (jnp.concatenate([v, jnp.zeros_like(v[:, :, :steps])], 2) if k in pad else v)
               for k, v in cache_j.items()}
    cache_t = convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, cache_j), "cpu")
    nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), s + t, np.int32)
        lj, cache_j = j_registry.get_api(cj).decode_step(pj, cache_j, jnp.asarray(nxt[:, None]),
                                                         jnp.asarray(pos))
        lt, cache_t = registry.get_api(ct).decode_step(pt, cache_t, torch.from_numpy(nxt[:, None]),
                                                       torch.from_numpy(pos))
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), rtol=TOL,
                                   atol=TOL * float(np.abs(np.asarray(lj)).max()),
                                   err_msg=f"step {t}")
        assert_cache_close(cache_t, cache_j, what=f"step {t} cache")
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        assert np.array_equal(to_np(torch.argmax(lt[:, -1], -1)), nxt)


def check_specs_and_round_trip(cj, ct):
    """The port's parameter count and per-layer specs are the reference's
    (whose layer groups are stacked), its cache specs equal the reference's,
    and parameters cross both ways bit for bit."""
    sj, st = j_registry.get_api(cj).specs(), registry.get_api(ct).specs()
    assert base.n_params(st) == j_base.n_params(sj)
    st_stacked = flat_specs(convert.stack_layers(
        base.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), st)))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in
            st_stacked.items()} == {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                                    for k, v in flat_specs(sj).items()}
    cs_j = j_registry.get_api(cj).init_cache_specs(3, 20)
    cs_t = registry.get_api(ct).init_cache_specs(3, 20)
    assert {k: (v.shape, v.init) for k, v in flat_specs(cs_t).items()} == {
        k: (v.shape, v.init) for k, v in flat_specs(cs_j).items()}
    pj, pt = params_pair(cj, ct, dtype=None)
    back, want = flat(convert.params_to_numpy(pt)), flat(pj)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = convert.unstack_layers(convert.stack_layers(pt), convert.layer_depths(ct))
    assert all(torch.equal(a, b) for a, b in zip(base.tree_leaves(pt), base.tree_leaves(again)))


def layer_params(stacked, i):
    """Layer ``i`` of a reference layer group (every leaf stacked on axis 0)."""
    return jax.tree_util.tree_map(lambda a: a[i], stacked)


def check_bf16_dtype_with_f32_params(cj, ct, batch, j_prefill_unrolled):
    """``dtype`` bf16 with f32 parameters, where the reference's layer scan
    refuses its carry (bf16 embeddings, f32 after the first residual add):
    the port's prefill against ``j_prefill_unrolled``, the reference's layer
    body in a Python loop, logits and every cache leaf at the f32 tolerance
    (both round the embedding to bf16 once, exactly)."""
    cj, ct = cj.with_(dtype=jnp.bfloat16), ct.with_(dtype=torch.bfloat16)
    pj, pt = params_pair(cj, ct)
    with np.testing.assert_raises(TypeError):  # the scan's carry changes dtype
        j_registry.get_api(cj).prefill(pj, to_jax(batch))
    lj, cache_j = j_prefill_unrolled(pj, to_jax(batch), cj)
    lt, cache_t = registry.get_api(ct).prefill(pt, to_torch(batch))
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(lj)).max()))
    assert_cache_close(cache_t, cache_j, what="bf16 prefill cache")


def flat_specs(tree, prefix=""):
    """{dotted path: leaf} of a tree of dicts whose leaves are ParamSpecs or
    tensors (either package's)."""
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in flat_specs(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}
