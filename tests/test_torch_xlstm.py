"""Parity of the port's xLSTM family (``repro_torch.models.xlstm``, the
registry's ``ssm``) with the JAX package's ``repro.models.xlstm``, on the
CPU.

Inputs: xlstm-125m's smoke variant (4 layers, d_model 128, 4 heads,
expand 2; ``slstm_every`` 2, so layers 1 and 3 run sLSTM and 0 and 2
mLSTM), parameters from the reference's ``materialize``, tokens from numpy
seeds. Every layer holds both blocks' parameters; the block a layer does not
run gets a zero gradient in both packages.

Tolerances (tests/torch_family_parity.py): f32 loss 1e-5 relative;
gradients, logits and every state leaf within 1e-5 x the leaf's largest
|value| plus 1e-5 relative (measured <= 3.5e-6 of the largest). With four
mLSTM layers in a row (``slstm_every`` 0) the gradients are ill-conditioned:
the stabilizer ``m`` drops out of the function but not of its f32 rounding,
and moving every parameter of the reference by one ulp moves its own
gradients by up to 2.6e-5 of a leaf's largest (``b_if``). There the
gradients are held within 5e-5 x the largest (measured 1.9e-5). bf16
parameters and ``dtype`` bf16: the loss within 2e-3 relative, as
tests/test_torch_moe.py holds bf16 models. ``dtype`` bf16 with f32
parameters, which the reference's ``lax.cond`` refuses (its branches'
outputs differ in dtype), is held against the layer body unrolled in JAX,
at the f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_125m as j_xlstm_cfg
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import layers as j_L
from repro.models import registry as j_registry
from repro.models import ssm as j_ssm
from repro.models import transformer as j_T
from repro.models import xlstm as j_xlstm
from repro_torch.configs import xlstm_125m
from repro_torch.configs.base import smoke_variant
from repro_torch.models import base, registry, xlstm
from repro_torch.training import train_step as ts
from torch_family_parity import (batch_np, check_bf16_dtype_with_f32_params,
                                 check_loss_and_grads, check_prefill_then_decode,
                                 check_specs_and_round_trip, layer_params, params_pair, to_jax,
                                 to_torch)


def configs(**kw):
    return (j_smoke_variant(j_xlstm_cfg.CONFIG).with_(**kw),
            smoke_variant(xlstm_125m.CONFIG).with_(**kw))


def test_block_choice_is_the_references():
    cj, ct = configs()
    assert [xlstm._is_slstm(ct, i) for i in range(ct.n_layers)] == [False, True, False, True]
    assert not any(xlstm._is_slstm(ct.with_(slstm_every=0), i) for i in range(4))
    assert [xlstm._is_slstm(xlstm_125m.CONFIG, i) for i in range(12)] == [
        i % 4 == 3 for i in range(12)]


@pytest.mark.parametrize("slstm_every,grad_tol", [(2, 1e-5), (0, 5e-5)])
def test_loss_and_grads_match_reference(slstm_every, grad_tol):
    cj, ct = configs(slstm_every=slstm_every)
    check_loss_and_grads(cj, ct, batch_np(ct), grad_atol_of_max=grad_tol)


def test_only_the_idle_blocks_go_without_a_gradient():
    """The block a layer does not run gets zero gradients, and only it: a
    training step that is not told which blocks are idle refuses the loss."""
    _, ct = configs()
    api = registry.get_api(ct)
    assert api.idle_params == ("layers.0.slstm", "layers.1.mlstm", "layers.2.slstm",
                               "layers.3.mlstm")
    pt = base.materialize(api.specs(), torch.Generator().manual_seed(0), torch.float32)
    batch = to_torch(batch_np(ct))
    _, g = ts.value_and_grad(api.loss_fn, pt, batch, api.idle_params)
    for i, lg in enumerate(g["layers"]):
        run, idle = ("slstm", "mlstm") if xlstm._is_slstm(ct, i) else ("mlstm", "slstm")
        assert not any(t.any() for t in base.tree_leaves(lg[idle])), i
        assert all(t.any() for t in base.tree_leaves(lg[run]) if t.numel() > 1), i
    with pytest.raises(RuntimeError, match="does not reach parameter layers.0.slstm"):
        ts.value_and_grad(api.loss_fn, pt, batch)


def test_bf16_loss_matches_reference():
    cj, ct = configs(dtype=jnp.bfloat16)
    ct = ct.with_(dtype=torch.bfloat16)
    pj, pt = params_pair(cj, ct, dtype=None)
    batch = batch_np(ct)
    lj = j_registry.get_api(cj).loss_fn(pj, to_jax(batch))
    lt = registry.get_api(ct).loss_fn(pt, to_torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)


def test_prefill_then_decode_matches_reference():
    """Prefill over 2 x 12 tokens, then 4 greedy decode steps from the
    carried states: logits, and every leaf of both blocks' states."""
    cj, ct = configs()
    check_prefill_then_decode(cj, ct, batch_np(ct, s=12, labels=False))


def test_specs_and_convert_round_trip():
    check_specs_and_round_trip(*configs())


def j_prefill_unrolled(params, batch, cfg):
    """The reference's ``prefill`` with its layer scan and ``lax.cond`` as a
    Python loop and branch: each layer from the zero states of
    ``init_cache_specs``, the idle block's state passed through."""
    x = j_L.embed(params["embed"], batch["tokens"]).astype(cfg.dtype)
    specs = j_xlstm.init_cache_specs(cfg, x.shape[0], 0)
    zero = {blk: jax.tree_util.tree_map(lambda sp: jnp.zeros(sp.shape[1:], sp.dtype), tree,
                                        is_leaf=lambda z: hasattr(z, "init"))
            for blk, tree in specs.items()}
    states = {"mlstm": [], "slstm": []}
    for i in range(cfg.n_layers):
        lp, st = layer_params(params["layers"], i), dict(zero)
        blk = "slstm" if j_xlstm._is_slstm(cfg, i) else "mlstm"
        y, st[blk] = getattr(j_ssm, f"{blk}_apply")(lp[blk], x, cfg, st[blk])
        x = x + y
        for name in states:
            states[name].append(st[name])
    cache = {blk: {k: jnp.stack([st[k] for st in sts]) for k in sts[0]}
             for blk, sts in states.items()}
    x = j_T.norm(cfg, params["ln_f"], x)
    return j_L.lm_logits(params["embed"], x[:, -1:], cfg.vocab), cache


def test_bf16_dtype_with_f32_params_matches_unrolled_reference():
    cj, ct = configs()
    check_bf16_dtype_with_f32_params(cj, ct, batch_np(ct, s=12, labels=False),
                                     j_prefill_unrolled)
