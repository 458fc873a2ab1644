"""Parity of the port's hybrid family (``repro_torch.models.hybrid``: the
Mamba2 backbone with one shared attention + MLP block) with the JAX
package's ``repro.models.hybrid``, on the CPU.

Inputs: zamba2-2.7b's smoke variant (4 Mamba2 layers, ``attn_every`` 2, so
two applications of the shared block; window 64; d_model 128, 4 heads of
32, d_state 16), and the same at 5 layers, whose last layer is a tail
without attention; parameters from the reference's ``materialize``, tokens
from numpy seeds.

Tolerances (tests/torch_family_parity.py): f32 loss 1e-5 relative;
gradients, logits and every cache leaf within 1e-5 x the leaf's largest
|value| plus 1e-5 relative (measured <= 3.7e-6 of the largest), but the
gradient of ``d_skip``: the per-head group norm after the skip is blind to
the scale of its input, so that gradient is the small residue of sums that
cancel, and moving every parameter of the reference by one ulp moves it by
up to 2.5e-4 of its largest entry (three draws). It is held within 1e-3 x
its largest (measured 2.3e-4, as close as the reference is to itself). bf16
parameters and ``dtype`` bf16: the loss within 2e-3 relative, as
tests/test_torch_moe.py holds bf16 models. ``dtype`` bf16 with f32
parameters, which the reference's layer scan refuses (its carry turns from
bf16 into f32), is held against the layer body unrolled in JAX, at the f32
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zamba2_2_7b as j_zamba
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import attention as j_attn
from repro.models import hybrid as j_hybrid
from repro.models import layers as j_L
from repro.models import registry as j_registry
from repro.models import ssm as j_ssm
from repro.models import transformer as j_T
from repro_torch.configs import zamba2_2_7b
from repro_torch.configs.base import smoke_variant
from repro_torch.models import hybrid, registry
from torch_family_parity import (batch_np, check_bf16_dtype_with_f32_params,
                                 check_loss_and_grads, check_prefill_then_decode,
                                 check_specs_and_round_trip, layer_params, params_pair, to_jax,
                                 to_torch)

DEPTHS = {"4_layers": dict(n_layers=4), "5_layers_tail": dict(n_layers=5)}


def configs(**kw):
    return (j_smoke_variant(j_zamba.CONFIG).with_(**kw),
            smoke_variant(zamba2_2_7b.CONFIG).with_(**kw))


def test_segments_are_the_references():
    for n, every in ((4, 2), (5, 2), (54, 9), (10, 9), (3, 0)):
        cj, ct = configs(n_layers=n, attn_every=every)
        assert hybrid._segments(ct) == j_hybrid._segments(cj)
        assert hybrid.n_apps(ct) == j_hybrid.n_apps(cj)
    _, ct = configs(n_layers=5)
    assert hybrid._segments(ct) == [(0, 2, True), (2, 2, True), (4, 1, False)]
    assert hybrid._segments(zamba2_2_7b.CONFIG.with_(n_layers=10)) == [(0, 9, True),
                                                                       (9, 1, False)]


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_loss_and_grads_match_reference(depth):
    cj, ct = configs(**DEPTHS[depth])
    check_loss_and_grads(cj, ct, batch_np(ct), leaf_atol_of_max={"mamba_layers.d_skip": 1e-3})


def test_loss_and_grads_with_the_shared_block_idle_match_reference():
    """One Mamba2 layer below ``attn_every`` 2: no segment reaches the shared
    block, whose parameters get zero gradients in both packages."""
    cj, ct = configs(n_layers=1, attn_every=2)
    assert hybrid.idle_params(ct) == ("shared",) and hybrid.idle_params(configs()[1]) == ()
    check_loss_and_grads(cj, ct, batch_np(ct), leaf_atol_of_max={"mamba_layers.d_skip": 1e-3})


def test_bf16_loss_matches_reference():
    cj, ct = configs(dtype=jnp.bfloat16)
    ct = ct.with_(dtype=torch.bfloat16)
    pj, pt = params_pair(cj, ct, dtype=None)
    batch = batch_np(ct)
    lj = j_registry.get_api(cj).loss_fn(pj, to_jax(batch))
    lt = registry.get_api(ct).loss_fn(pt, to_torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_prefill_then_decode_matches_reference(depth):
    """Prefill over 2 x 12 tokens, then 4 greedy decode steps from the KV
    caches lengthened by 4 zero positions: logits, every Mamba2 state and
    each application's K and V."""
    cj, ct = configs(**DEPTHS[depth])
    check_prefill_then_decode(cj, ct, batch_np(ct, s=12, labels=False), pad=("k", "v"))


def test_specs_and_convert_round_trip():
    """``mamba_layers`` stacked in the reference and listed in the port, the
    ``shared`` block as it is in both."""
    cj, ct = configs(n_layers=5)
    check_specs_and_round_trip(cj, ct)
    _, pt = params_pair(cj, ct)
    assert len(pt["mamba_layers"]) == 5 and isinstance(pt["shared"]["attn"]["wq"], torch.Tensor)


def j_prefill_unrolled(params, batch, cfg):
    """The reference's ``prefill`` with its Mamba2 layer scan as a Python
    loop, each layer from the zero states of ``_zeros_states``."""
    x = j_L.embed(params["embed"], batch["tokens"]).astype(cfg.dtype)
    b, s = x.shape[:2]
    positions = jnp.arange(s)
    w = j_T.cache_len(cfg, s)
    zero = jax.tree_util.tree_map(lambda a: a[0], j_hybrid._zeros_states(cfg, b, 1))
    m_states, ks, vs = [], [], []
    for start, length, has_attn in j_hybrid._segments(cfg):
        for i in range(start, start + length):
            y, st = j_ssm.mamba2_apply(layer_params(params["mamba_layers"], i), x, cfg, zero)
            x = x + y
            m_states.append(st)
        if has_attn:
            sp = params["shared"]
            q, k, v = j_T.qkv(sp["attn"], j_T.norm(cfg, sp["ln1"], x), cfg, positions)
            o = j_attn.blockwise_attention(q, k, v, causal=True, window=cfg.window)
            x = x + o.reshape(b, s, -1) @ sp["attn"]["wo"]
            x = x + j_L.mlp(sp["mlp"], j_T.norm(cfg, sp["ln2"], x), cfg.act)
            ks.append(k[:, -w:])
            vs.append(v[:, -w:])
    x = j_T.norm(cfg, params["ln_f"], x)
    cache = {"mamba": {k: jnp.stack([st[k] for st in m_states]) for k in m_states[0]},
             "k": jnp.stack(ks), "v": jnp.stack(vs)}
    return j_L.lm_logits(params["embed"], x[:, -1:], cfg.vocab), cache


def test_bf16_dtype_with_f32_params_matches_unrolled_reference():
    cj, ct = configs(n_layers=5)
    check_bf16_dtype_with_f32_params(cj, ct, batch_np(ct, s=12, labels=False),
                                     j_prefill_unrolled)
