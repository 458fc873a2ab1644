"""The twin of tests/test_arch_smoke.py for the port: a REDUCED config of the
same family runs one loss-and-gradient pass (and a prefill and one decode
step) on the CPU, for each of the reference's ten architectures; shapes and
finite values are asserted as the reference's test asserts them, and the
loss is held to the JAX package's on the same parameters and batch (rtol
1e-5: one f32 function summed in another order). The port's architectures
are the reference's, config for config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import base as j_base
from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch.configs import ARCHS, ModelConfig, smoke_variant
from repro_torch.models import base, registry
from repro_torch.training import train_step as ts

BATCH, SEQ = 2, 32


def _batch_for(cfg, seed=1):
    rng = np.random.default_rng(seed)
    n_txt = SEQ - cfg.n_img_tokens if cfg.family == "vlm" else SEQ
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, n_txt)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, n_txt)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((BATCH, cfg.enc_len, cfg.d_model),
                                              dtype=np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal((BATCH, cfg.n_img_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _setup(arch):
    """(port cfg, reference cfg, port params, reference params): the smoke
    variant's parameters drawn by the reference (f32), carried to the port."""
    ct, cj = smoke_variant(ARCHS[arch]), j_smoke_variant(J_ARCHS[arch])
    pj = j_base.materialize(j_registry.get_api(cj).specs(), jax.random.PRNGKey(0), jnp.float32)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")
    return ct, cj, pt, pj


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step(arch):
    ct, cj, pt, pj = _setup(arch)
    batch = _batch_for(ct)
    api = registry.get_api(ct)
    loss, grads = ts.value_and_grad(api.loss_fn, pt,
                                    {k: torch.from_numpy(v) for k, v in batch.items()},
                                    api.idle_params)
    assert np.isfinite(float(loss)), f"{arch}: loss not finite"
    assert 1.0 < float(loss) < 20.0, f"{arch}: loss {float(loss)}"
    gnorm = sum(float(torch.sum(torch.square(g.float()))) for g in base.tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0, f"{arch}: bad grads"
    want = j_registry.get_api(cj).loss_fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5, err_msg=arch)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_decode_step(arch):
    ct, _, pt, _ = _setup(arch)
    api = registry.get_api(ct)
    batch = {k: torch.from_numpy(v) for k, v in _batch_for(ct).items() if k != "labels"}

    logits, cache = api.prefill(pt, batch)
    assert logits.shape[0] == BATCH and logits.shape[1] == 1
    assert bool(torch.isfinite(logits.float()).all()), f"{arch}: prefill NaN"

    n_txt = batch["tokens"].shape[1]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.full((BATCH,), n_txt, dtype=torch.int32)
    logits2, cache2 = api.decode_step(pt, cache, tok, pos)
    assert logits2.shape[:2] == (BATCH, 1)
    assert bool(torch.isfinite(logits2.float()).all()), f"{arch}: decode NaN"
    # cache structure is preserved, nested states (xlstm, hybrid) included
    assert {k: (v.shape, v.dtype) for k, v in base.tree_paths(cache).items()} == {
        k: (v.shape, v.dtype) for k, v in base.tree_paths(cache2).items()}


def _port_config(cfg) -> ModelConfig:
    """The reference's config as the port's ModelConfig (its dtype a torch dtype)."""
    kw = dataclasses.asdict(cfg)
    kw["dtype"] = getattr(torch, jnp.dtype(cfg.dtype).name)
    return ModelConfig(**kw)


def test_ported_archs_are_the_references():
    """All ten, nothing missing, every config equal, every family served."""
    assert set(ARCHS) == set(J_ARCHS) and len(ARCHS) == 10
    for arch, cfg in ARCHS.items():
        assert _port_config(J_ARCHS[arch]) == cfg, arch
        assert registry.get_api(cfg).cfg is cfg
    assert {cfg.family for cfg in ARCHS.values()} == {"dense", "moe", "encdec", "ssm", "vlm",
                                                      "hybrid"}
    with pytest.raises(NotImplementedError, match="family"):
        registry.get_api(ARCHS["tinyllama-1.1b"].with_(family="rnn"))
