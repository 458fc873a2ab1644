"""Parity of the port's training path with the JAX package's on the CPU:
``transformer.loss_fn`` and its gradients (``models/layers.py``'s two
cross-entropies, ``forward``, ``attn_block``, the VLM embeddings), AdamW
(``training/optim.py``), ``make_train_step`` with and without microbatches,
and checkpoints that each package restores from the other's files. On the
CPU the port's attention is the plain ``blockwise_attention``, as the
reference's training forward computes it; the flash kernel's autograd entry
is held against that function here through its plain forward, and on the
card by chip_smoke.py's ``train`` phase.

Inputs: tinyllama-1.1b's smoke variant (4 layers, d_model 128, vocab 512),
parameters from the reference's ``materialize`` (PRNGKey 0) carried over by
``convert.params_from_numpy``, batches from numpy seeds.

Tolerances, each with its reason:
- f32 loss: rtol 1e-6 (measured <= 2.3e-7 over seeds 0-2 and every case
  here: the two frameworks sum the same products in another order).
- f32 gradients: per leaf, atol 1e-5 x the leaf's largest |g| plus rtol 1e-5
  (measured <= 2.9e-6 of the leaf's largest entry, seeds 0-2).
- bf16 parameters (cfg.dtype f32, the end-to-end run's setting): the
  products are f32 of bf16 weights and the gradients are rounded to bf16,
  where an f32 difference of an ulp can move an entry by one bf16 ulp
  (2^-8 relative): loss rtol 1e-6, gradients rtol 2^-7 plus atol 2^-8 x the
  leaf's largest |g| (measured <= 3.1e-3 of the leaf's largest entry).
- AdamW on one state: rtol 1e-6. The port and the eager reference do the
  same float32 operations in the same order; ``pow`` and ``cos`` of two
  libraries may differ by an ulp, which the bound covers.
- Three ``make_train_step`` steps against the jitted reference: the losses
  and grad norms within rtol 1e-5 (measured <= 6.8e-7). The gradients agree
  to ~1e-6 of each leaf's largest entry, but AdamW divides each entry by its
  own root mean square plus eps (1e-8): an entry whose gradient cancels to
  ~1e-9, where the frameworks' sums differ by a few 1e-10, takes a step
  g / (|g| + eps) that they disagree on by up to a few percent. So the
  parameters are held to atol 1e-4, a tenth of one step at lr 1e-3 (measured
  4.0e-5, the first step alone 2.2e-5; on the same gradients the port's
  update equals the reference's to 3e-8, jitted or not); the moments to
  atol 1e-4 x the leaf's largest entry plus rtol 1e-4 (measured 1.9e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import tinyllama_1_1b as j_tinyllama
from repro.configs.base import smoke_variant as j_smoke_variant
from repro.models import base as j_base
from repro.models import registry as j_registry
from repro.models import transformer as j_T
from repro.training import optim as j_optim
from repro.training import train_step as j_ts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import tinyllama_1_1b
from repro_torch.configs.base import smoke_variant
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.models import attention as attn
from repro_torch.models import base, registry, transformer
from repro_torch.training import optim
from repro_torch.training import train_step as ts
from test_torch_parity import to_np

B, S = 2, 32


def configs(**kw):
    cj = j_smoke_variant(j_tinyllama.CONFIG).with_(**kw)
    ct = smoke_variant(tinyllama_1_1b.CONFIG).with_(**kw)
    return cj, ct


def params_pair(cj, ct, dtype=jnp.float32, seed=0):
    """The reference's parameters (``dtype``; None keeps the specs' bf16) and
    the port's copy."""
    pj = j_base.materialize(j_registry.get_api(cj).specs(), jax.random.PRNGKey(seed), dtype)
    return pj, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")


def batch_np(cfg, seed=1, b=B, s=S, n_img=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s - n_img)).astype(np.int32)
    labels[:, :3] = -1  # ignored positions
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s - n_img)).astype(np.int32),
           "labels": labels}
    if n_img:
        out["img_embeds"] = rng.standard_normal((b, n_img, cfg.d_model)).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def flat(tree):
    """{dotted path: float32 numpy} of a reference-layout tree (numpy or JAX)."""
    return {k: to_np(v) for k, v in base.tree_paths(tree).items()}


def assert_trees_close(port_tree, ref_tree, *, rtol, atol_of_max, what):
    """Leaf by leaf: |port - ref| <= atol_of_max * max|ref leaf| + rtol * |ref|.
    ``port_tree`` is in the port's layout (tensors), ``ref_tree`` the reference's."""
    got = flat(base.tree_map(convert.tensor_to_numpy, convert.stack_layers(port_tree)))
    want = flat(ref_tree)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        atol = atol_of_max * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def loss_and_grads(ct, pt, batch):
    return ts.value_and_grad(lambda p, b: transformer.loss_fn(p, b, ct), pt, to_torch(batch))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("xent_chunk", [0, 16])
def test_loss_and_grads_match_reference(remat, xent_chunk):
    cj, ct = configs(remat=remat, xent_chunk=xent_chunk)
    pj, pt = params_pair(cj, ct)
    batch = batch_np(ct)
    lj, gj = jax.value_and_grad(j_registry.get_api(cj).loss_fn)(pj, to_jax(batch))
    lt, gt = ts.value_and_grad(registry.get_api(ct).loss_fn, pt, to_torch(batch))
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_trees_close(gt, gj, rtol=1e-5, atol_of_max=1e-5, what="grad")


def test_remat_and_chunking_change_no_value():
    """Rematerialization and the chunked cross-entropy are memory choices:
    the port's loss and gradients are the same function with or without them."""
    _, ct = configs()
    _, pt = params_pair(*configs())
    batch = batch_np(ct)
    l0, g0 = loss_and_grads(ct, pt, batch)
    for kw in (dict(remat=True), dict(xent_chunk=8), dict(remat=True, xent_chunk=32)):
        l1, g1 = loss_and_grads(ct.with_(**kw), pt, batch)
        torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
        for a, b in zip(base.tree_leaves(g1), base.tree_leaves(g0)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_vlm_loss_and_grads_match_reference():
    """The vlm branch (image embeddings prepended, their positions cut from
    the loss), called on the module."""
    n_img = 8
    cj, ct = configs(family="vlm", n_img_tokens=n_img)
    pj, pt = params_pair(cj, ct)
    batch = batch_np(ct, n_img=n_img)
    lj, gj = jax.value_and_grad(lambda p, b: j_T.loss_fn(p, b, cj))(pj, to_jax(batch))
    lt, gt = loss_and_grads(ct, pt, batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_trees_close(gt, gj, rtol=1e-5, atol_of_max=1e-5, what="grad")
    # the image embeddings reach the loss: without them it changes
    lt0, _ = loss_and_grads(ct, pt, {k: v for k, v in batch.items() if k != "img_embeds"})
    assert float(lt0) != float(lt)


def test_bf16_params_loss_and_grads_match_reference():
    """Parameters as ``materialize`` makes them without a dtype (bf16), the
    end-to-end run's setting."""
    cj, ct = configs()
    pj, pt = params_pair(cj, ct, dtype=None)
    assert all(t.dtype == torch.bfloat16 for t in base.tree_leaves(pt))
    batch = batch_np(ct)
    lj, gj = jax.value_and_grad(j_registry.get_api(cj).loss_fn)(pj, to_jax(batch))
    lt, gt = loss_and_grads(ct, pt, batch)
    assert all(g.dtype == torch.bfloat16 for g in base.tree_leaves(gt))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_trees_close(gt, gj, rtol=2**-7, atol_of_max=2**-8, what="grad")


# ---------------------------------------------------------------------------
# the cross-entropies alone
# ---------------------------------------------------------------------------
def test_softmax_xent_and_chunked_match_reference():
    from repro.models import layers as j_L
    from repro_torch.models import layers as L

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    labels = rng.integers(-1, 37, (2, 24)).astype(np.int32)  # vocab 37 of 40: a masked tail
    ej, et = {"table": jnp.asarray(table)}, {"table": torch.from_numpy(table)}
    logits_j = j_L.lm_logits(ej, jnp.asarray(x), 37)
    want = float(j_L.softmax_xent(logits_j, jnp.asarray(labels)))
    got = L.softmax_xent(L.lm_logits(et, torch.from_numpy(x), 37), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    want_c = float(j_L.tied_xent_chunked(ej, jnp.asarray(x), jnp.asarray(labels), 37, 8))
    got_c = L.tied_xent_chunked(et, torch.from_numpy(x), torch.from_numpy(labels), 37, 8)
    np.testing.assert_allclose(float(got_c), want_c, rtol=1e-6)
    with pytest.raises(ValueError):
        L.tied_xent_chunked(et, torch.from_numpy(x), torch.from_numpy(labels), 37, 7)


# ---------------------------------------------------------------------------
# the flash kernel's autograd entry (its plain forward on the CPU)
# ---------------------------------------------------------------------------
def test_flash_attention_train_grads_match_blockwise():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k, v = torch.randn(2, 40, 2, 16, generator=g), torch.randn(2, 40, 2, 16, generator=g)
    do = torch.randn(2, 40, 4, 16, generator=g)
    outs = []
    for f in (lambda *a: flash_ops.flash_attention_train(*a, causal=True),
              lambda *a: attn.blockwise_attention(*a, causal=True, block=16)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = f(*leaves)
        outs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
    for name, a, b in zip(("o", "dq", "dk", "dv"), *outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=lambda m: f"{name}: {m}")


def test_flash_attention_fwd_refuses_inputs_that_require_grad():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = v = torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="flash_attention_train"):
        flash_attention_fwd(q, k, v)
    with torch.no_grad():
        flash_attention_fwd(q, k, v)
    flash_attention_fwd(q.detach(), k, v)


def test_train_attention_takes_the_autograd_entry_on_cuda(monkeypatch):
    """On a CUDA tensor with no window, training attention is the autograd
    entry (never ``prefill_attention``'s forward-only call); elsewhere the
    blockwise attention. Device types are faked: the choice is by type."""
    _, ct = configs()
    calls = []
    monkeypatch.setattr(flash_ops, "flash_attention_train",
                        lambda *a, **kw: calls.append("entry") or a[0])
    monkeypatch.setattr(attn, "blockwise_attention",
                        lambda *a, **kw: calls.append("blockwise") or a[0])

    class Fake:
        device = torch.device("cuda")

    transformer.train_attention(Fake(), None, None, ct)
    transformer.train_attention(Fake(), None, None, ct.with_(window=64))
    transformer.train_attention(torch.zeros(1), None, None, ct)
    assert calls == ["entry", "blockwise", "blockwise"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def optim_state(seed=4):
    """Parameters (f32 and bf16 leaves), gradients and a mid-run AdamW state."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "h": {"x": (3, 4)}}

    def tree(f):
        return {"w": f(shapes["w"]), "b": f(shapes["b"]), "h": {"x": f(shapes["h"]["x"])}}

    p = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = tree(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
    m = tree(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))
    v = tree(lambda s: (rng.random(s) * 0.1).astype(np.float32))
    p["h"]["x"] = p["h"]["x"].astype(jnp.bfloat16)
    return p, g, m, v


def j_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def t_tree(t):
    return base.tree_map(lambda a: convert.tensor_from_numpy(a, "cpu"), t)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_matches_reference(clip_norm):
    p, g, m, v = optim_state()
    cfg_kw = dict(lr=1e-2, warmup=3, total_steps=20, clip_norm=clip_norm)
    jcfg, tcfg = j_optim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    jp, js, jm = j_optim.update(jcfg, j_tree(p), j_tree(g),
                                j_optim.OptState(j_tree(m), j_tree(v), jnp.int32(5)))
    tp = t_tree(p)
    tp_out, ts_out, tm = optim.update(tcfg, tp, t_tree(g),
                                      optim.OptState(t_tree(m), t_tree(v),
                                                     torch.tensor(5, dtype=torch.int32)))
    assert tp_out is tp and tp["h"]["x"].dtype == torch.bfloat16  # in place, dtype kept
    assert int(ts_out.count) == int(js.count) == 6
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    for name, a, b in (("params", tp_out, jp), ("m", ts_out.m, js.m), ("v", ts_out.v, js.v)):
        assert_trees_close(a, b, rtol=1e-6, atol_of_max=0, what=name)


def test_schedule_and_global_norm_match_reference():
    cfg_kw = dict(lr=3e-4, warmup=20, total_steps=150)
    jcfg, tcfg = j_optim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    for step in (0, 1, 7, 20, 21, 85, 149, 150, 400):
        want = float(j_optim.schedule(jcfg, jnp.int32(step)))
        got = float(optim.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))
    _, g, _, _ = optim_state()
    np.testing.assert_allclose(float(optim.global_norm(t_tree(g))),
                               float(j_optim.global_norm(j_tree(g))), rtol=1e-6)


def test_opt_state_specs_and_init():
    _, ct = configs()
    specs = registry.get_api(ct).specs()
    os_specs = optim.opt_state_specs(specs)
    assert all(base.is_spec(s) and s.dtype == torch.float32 and s.init == "zeros"
               for s in base.tree_leaves(os_specs.m))
    assert os_specs.count.dtype == torch.int32 and os_specs.count.shape == ()
    _, pt = params_pair(*configs(), dtype=None)
    st = optim.init(pt)
    for p, m, v in zip(*(base.tree_leaves(t) for t in (pt, st.m, st.v))):
        assert m.shape == v.shape == p.shape and m.dtype == v.dtype == torch.float32
        assert not m.any() and not v.any() and m.data_ptr() != v.data_ptr()
    assert st.count.dtype == torch.int32 and int(st.count) == 0


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jitted_reference(microbatches):
    cj, ct = configs()
    pj, pt = params_pair(cj, ct)
    ocfg_kw = dict(lr=1e-3, warmup=2, total_steps=10)
    j_step = jax.jit(j_ts.make_train_step(cj, j_optim.AdamWConfig(**ocfg_kw), microbatches))
    t_step = ts.make_train_step(ct, optim.AdamWConfig(**ocfg_kw), microbatches)
    js, tst = j_optim.init(pj), optim.init(pt)
    for i in range(3):
        batch = batch_np(ct, seed=10 + i, b=4)
        pj, js, jm = j_step(pj, js, to_jax(batch))
        pt, tst, tm = t_step(pt, tst, to_torch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(tst.count) == 3
    got, want = flat(convert.params_to_numpy(pt)), flat(pj)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    for name, a, b in (("m", tst.m, js.m), ("v", tst.v, js.v)):
        assert_trees_close(a, b, rtol=1e-4, atol_of_max=1e-4, what=name)


def test_microbatches_split_the_batch_evenly():
    _, ct = configs()
    _, pt = params_pair(*configs())
    step = ts.make_train_step(ct, optim.AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError):
        step(pt, optim.init(pt), to_torch(batch_np(ct, b=4)))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def train_state_pair():
    """bf16 parameters and a non-trivial f32 AdamW state, in both packages."""
    cj, ct = configs()
    pj, pt = params_pair(cj, ct, dtype=None)
    rng = np.random.default_rng(5)
    mv = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pj)
          for _ in range(2)]
    sj = j_optim.OptState(*map(j_tree, mv), jnp.int32(7))
    st = convert.opt_state_from_numpy((*mv, np.int32(7)), ct, "cpu")
    return cj, ct, (pj, sj), (pt, st)


def assert_bit_equal(port_tree, ref_tree):
    got = base.tree_paths(convert.stack_layers(port_tree))
    want = base.tree_paths(ref_tree)
    assert set(got) == set(want)
    for k, t in got.items():
        w = np.asarray(want[k])
        if t.dtype == torch.bfloat16:
            assert w.dtype.name == "bfloat16", k
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16), k)
        else:
            assert t.numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(t.numpy(), w, k)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    cj, ct, ref, port = train_state_pair()
    j_ckpt.save(tmp_path / "c", ref, step=7, extra={"by": "reference"})
    like = convert.stack_layers(base.tree_map(torch.zeros_like, port))
    tree, manifest = ckpt.restore(tmp_path / "c", like, device="cpu")
    assert manifest["step"] == 7 and manifest["extra"] == {"by": "reference"}
    tree = convert.unstack_layers(tree, convert.layer_depths(ct))
    assert_bit_equal(tree, ref)
    assert len(tree[0]["layers"]) == ct.n_layers and isinstance(tree[1], optim.OptState)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cj, ct, ref, port = train_state_pair()
    ckpt.save(tmp_path / "c", convert.stack_layers(port), step=7)
    like = jax.tree_util.tree_map(jnp.zeros_like, ref)
    tree, manifest = j_ckpt.restore(tmp_path / "c", like)
    assert manifest["step"] == 7
    assert manifest["leaves"]["0.embed.table"]["dtype"] == "bfloat16"
    assert_bit_equal(port, tree)


def test_stack_and_unstack_layers_invert():
    cj, ct, ref, (pt, st) = train_state_pair()
    back = convert.unstack_layers(convert.stack_layers((pt, st)), convert.layer_depths(ct))
    for a, b in zip(base.tree_leaves((pt, st)), base.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(convert.params_to_numpy(pt)["layers"]["attn"]["wq"],
                                  to_np(ref[0]["layers"]["attn"]["wq"]))
    on = convert.opt_state_to_numpy(st)
    assert int(on.count) == 7 and on.m["layers"]["mlp"]["w_in"].shape[0] == ct.n_layers
