"""Parity of the port's Multi-head Latent Attention (``repro_torch.models.mla``)
and deepseek-v3's MLA branches of ``repro_torch.models.moe`` with the JAX
package's ``repro.models.mla`` and ``repro.models.moe``, on the CPU, where
the explicit form's attention is the plain blockwise attention, as in the
reference.

Inputs: deepseek-v3-671b's smoke variant (d_model 128, 4 heads, q_lora_rank
64, kv_lora_rank 32, rope 16, nope 32 and v 32 wide, so q and k heads of 48
beside v heads of 32; 8 experts top-2 of width 64, one shared expert, one
dense first layer of width 256, MTP depth 1, vocab 512), cut to 2 layers
(1 dense, 1 MoE). ``mla_attention`` and ``mla_decode`` take parameters and
inputs drawn by numpy from a seed; the model tests the reference's
``materialize`` carried over by ``convert.params_from_numpy``.

Tolerances: f32 throughout. Outputs, logits, losses and computed caches
within rtol 1e-5 or atol 1e-5 (one f32 function, its sums in another
order). Cache rows that decode does not write are copies in both
frameworks, and are held exactly. Gradients: atol 1e-5 x the leaf's largest
|g| plus rtol 1e-5, as tests/test_torch_moe.py holds the MoE family's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as j_deepseek_v3
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch.configs import deepseek_v3_671b
from repro_torch.configs.base import smoke_variant
from repro_torch.models import base, mla, moe, registry
from repro_torch.training import train_step as ts
from test_torch_moe import params_pair
from test_torch_parity import to_np
from test_torch_train import assert_trees_close, batch_np, flat, to_jax, to_torch
from test_torch_transformer import by_path

TOL = dict(atol=1e-5, rtol=1e-5)


def configs(**kw):
    kw = {"n_layers": 2, **kw}
    return (j_smoke_variant(j_deepseek_v3.CONFIG).with_(**kw),
            smoke_variant(deepseek_v3_671b.CONFIG).with_(**kw))


def mla_params(ct, seed=0):
    """One layer's MLA parameters from numpy, by the port's specs' shapes:
    normal / sqrt(fan-in), the norms' scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        return (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[0])).astype(np.float32)

    return base.tree_map(draw, mla.mla_specs(ct))


def as_torch(tree):
    return base.tree_map(torch.from_numpy, tree)


def test_specs_match_reference():
    cj, ct = configs()
    sj, st = by_path(j_mla.mla_specs(cj)), by_path(mla.mla_specs(ct))
    assert sj.keys() == st.keys()
    for k, a in sj.items():
        assert (a.shape, a.axes, a.init) == (st[k].shape, st[k].axes, st[k].init), k
    st = mla.mla_specs(ct)
    # q and k heads of nope + rope beside v heads of v_head_dim
    assert st["wq_b"].shape[1] == ct.n_heads * 48 and st["wkv_b"].shape[1] == ct.n_heads * 64


@pytest.mark.parametrize("return_cache", [False, True])
def test_mla_attention_matches_reference(return_cache):
    cj, ct = configs()
    p = mla_params(ct)
    x = np.random.default_rng(1).standard_normal((2, 24, ct.d_model)).astype(np.float32)
    pos = np.arange(24)
    oj = j_mla.mla_attention({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in p.items()},
                             jnp.asarray(x), cj, jnp.asarray(pos), return_cache=return_cache)
    ot = mla.mla_attention(as_torch(p), torch.from_numpy(x), ct, torch.from_numpy(pos),
                           return_cache=return_cache)
    if return_cache:
        (oj, (ckv_j, kr_j)), (ot, (ckv_t, kr_t)) = oj, ot
        assert ckv_t.shape == (2, 24, ct.kv_lora_rank) and kr_t.shape == (2, 24, ct.rope_head_dim)
        np.testing.assert_allclose(to_np(ckv_t), np.asarray(ckv_j), **TOL)
        np.testing.assert_allclose(to_np(kr_t), np.asarray(kr_j), **TOL)
    assert ot.shape == x.shape and ot.dtype == torch.float32
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), **TOL)


@pytest.mark.parametrize("pos", [[0, 5], [7, 3], [8, 13], [21, 9]],
                         ids=["first", "last_row", "wraps", "wraps_twice"])
def test_mla_decode_matches_reference(pos):
    """One absorbed-form step over a cache of 8 positions, written at pos % 8
    (``wraps``: pos 8 and 13 write rows 0 and 5); the mask keeps
    min(pos + 1, 8) positions."""
    cj, ct = configs()
    p = mla_params(ct, seed=2)
    rng = np.random.default_rng(3)
    b, s = 2, 8
    x = rng.standard_normal((b, 1, ct.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, s, ct.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s, ct.rope_head_dim)).astype(np.float32)
    pos = np.array(pos, np.int32)
    oj, ckv_j, kr_j = j_mla.mla_decode(
        {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in p.items()}, jnp.asarray(x), cj,
        jnp.asarray(pos), jnp.asarray(ckv), jnp.asarray(kr))
    ot, ckv_t, kr_t = mla.mla_decode(as_torch(p), torch.from_numpy(x), ct, torch.from_numpy(pos),
                                     torch.from_numpy(ckv), torch.from_numpy(kr))
    assert ot.shape == (b, 1, ct.d_model)
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), **TOL)
    written = np.zeros((b, s), bool)
    written[np.arange(b), pos % s] = True
    for name, t, j, before in (("ckv", ckv_t, ckv_j, ckv), ("krope", kr_t, kr_j, kr)):
        t, j = to_np(t), np.asarray(j)
        np.testing.assert_array_equal(t[~written], j[~written], err_msg=name)  # copies
        np.testing.assert_array_equal(t[~written], before[~written], err_msg=name)
        np.testing.assert_allclose(t[written], j[written], **TOL, err_msg=name)


def test_init_cache_specs_match_reference():
    for kw in ({}, dict(first_k_dense=0), dict(n_layers=4, first_k_dense=3)):
        cj, ct = configs(**kw)
        sj = j_registry.get_api(cj).init_cache_specs(3, 20)
        st = registry.get_api(ct).init_cache_specs(3, 20)
        want = {"moe_ckv", "moe_krope"} | ({"dense_ckv", "dense_krope"} if ct.first_k_dense
                                           else set())
        assert set(st) == set(sj) == want, kw
        for name in st:
            assert (st[name].shape, st[name].axes, st[name].init) == (
                sj[name].shape, sj[name].axes, sj[name].init), (kw, name)
            assert st[name].dtype == torch.float32
        n_moe = ct.n_layers - ct.first_k_dense
        assert st["moe_ckv"].shape == (n_moe, 3, 20, ct.kv_lora_rank)
        assert st["moe_krope"].shape == (n_moe, 3, 20, ct.rope_head_dim)


@pytest.mark.parametrize("hand_off", ["rolling", "padded"])
def test_prefill_then_decode_matches_reference(hand_off):
    """moe.prefill (MLA, one dense first layer, one MoE layer, a shared
    expert, the MTP block materialized) then 4 greedy decode steps, each
    step's logits and latent caches. ``rolling`` hands the prefill's cache
    over as it is, exactly as long as the prompt, so the first step writes
    at pos % S = 0 over the prompt's first position (the reference's
    hand-off, ROADMAP.md queue 3); ``padded`` lengthens it by 4 zero rows
    first, as chip_smoke.py does."""
    cj, ct = configs()
    pj, pt = params_pair(cj, ct)
    b, s, steps = 3, 12, 4
    tok = np.random.default_rng(7).integers(0, ct.vocab, (b, s)).astype(np.int32)
    lj, cache_j = j_moe.prefill(pj, {"tokens": jnp.asarray(tok)}, cj)
    lt, cache_t = registry.get_api(ct).prefill(pt, {"tokens": torch.from_numpy(tok)})
    assert set(cache_t) == set(cache_j) == {"dense_ckv", "dense_krope", "moe_ckv", "moe_krope"}
    specs = registry.get_api(ct).init_cache_specs(b, s)
    for name, c in cache_t.items():
        assert tuple(c.shape) == specs[name].shape == cache_j[name].shape, name
        np.testing.assert_allclose(to_np(c), np.asarray(cache_j[name]), **TOL, err_msg=name)
    np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL)
    cache_j = {n: np.asarray(c) for n, c in cache_j.items()}
    if hand_off == "padded":
        cache_j = {n: np.concatenate([c, np.zeros_like(c[:, :, :steps])], 2)
                   for n, c in cache_j.items()}
    cache_t = convert.cache_from_numpy(cache_j, "cpu")
    first = {n: c[:, :, 0].copy() for n, c in cache_j.items()}
    nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((b,), s + t, np.int32)
        lj, cache_j = j_moe.decode_step(pj, cache_j, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
                                        cj)
        lt, cache_t = registry.get_api(ct).decode_step(pt, cache_t, torch.from_numpy(nxt[:, None]),
                                                       torch.from_numpy(pos))
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), **TOL, err_msg=f"step {t}")
        for name in cache_j:
            np.testing.assert_allclose(to_np(cache_t[name]), np.asarray(cache_j[name]), **TOL,
                                       err_msg=f"step {t} {name}")
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        assert np.array_equal(to_np(torch.argmax(lt[:, -1], -1)), nxt)
    for name, c in cache_t.items():
        overwritten = not np.array_equal(to_np(c[:, :, 0]), first[name])
        assert overwritten == (hand_off == "rolling"), name


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """loss_fn with MLA in every layer and in the MTP block, f32: the loss and
    every gradient leaf against jax.value_and_grad of the reference's."""
    cj, ct = configs(remat=remat)
    pj, pt = params_pair(cj, ct)
    assert "mtp" in pt and "wkv_b" in pt["mtp"]["block"]["attn"]
    batch = batch_np(ct)
    lj, gj = jax.jit(jax.value_and_grad(j_registry.get_api(cj).loss_fn))(pj, to_jax(batch))
    lt, gt = ts.value_and_grad(registry.get_api(ct).loss_fn, pt, to_torch(batch))
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert_trees_close(gt, gj, rtol=1e-5, atol_of_max=1e-5, what="grad")


def test_convert_round_trip():
    """deepseek-v3's parameter tree (MLA's leaves inside ``dense_layers``,
    ``moe_layers`` and ``mtp``) and its latent cache cross both ways as they
    are: the existing groups carry MLA, and the caches keep S on axis 2."""
    cj, ct = configs()
    pj, pt = params_pair(cj, ct, dtype=None)
    assert pt["dense_layers"][0]["attn"]["wkv_b"].dtype == torch.bfloat16
    assert pt["moe_layers"][0]["moe"]["router"].dtype == torch.float32
    back, want = flat(convert.params_to_numpy(pt)), flat(pj)
    assert back.keys() == want.keys()
    assert any("q_ln" in k for k in want) and any(k.startswith("mtp") and "wq_a" in k
                                                  for k in want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert base.n_params(moe.specs(ct)) == sum(v.size for v in want.values())
    rng = np.random.default_rng(4)
    cache = {n: rng.standard_normal(s.shape).astype(np.float32)
             for n, s in registry.get_api(ct).init_cache_specs(2, 10).items()}
    ct_cache = convert.cache_from_numpy(cache, "cpu")
    for n, a in cache.items():
        assert ct_cache[n].shape[2] == 10
        np.testing.assert_array_equal(convert.tensor_to_numpy(ct_cache[n]), a, err_msg=n)


def test_registry_builds_the_published_config():
    """deepseek-v3-671b at its published widths builds (specs only: 61
    layers are ~671 B parameters): the attention of every layer is MLA, and
    the counts follow the config."""
    api = registry.get_api(deepseek_v3_671b.CONFIG)
    s = api.specs()
    assert len(s["dense_layers"]) == 3 and len(s["moe_layers"]) == 58
    assert s["moe_layers"][0]["attn"]["wq_b"].shape == (1536, 128 * 192)
    assert s["moe_layers"][0]["attn"]["wkv_b"].shape == (512, 128 * 256)
    assert s["moe_layers"][0]["moe"]["w_in"].shape == (256, 7168, 2048)
    assert 6.5e11 < base.n_params(s) < 7.0e11
    four = registry.get_api(deepseek_v3_671b.CONFIG.with_(n_layers=4))
    assert abs(base.n_params(four.specs()) - 14.87e9) < 0.01e9
