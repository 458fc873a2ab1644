"""The plain reference against the program (``repro_torch``) at small sizes
on the CPU, in float32: losses, every gradient leaf, the prefill's logits
and cache, and the MoE layer's capacity drops in the program's order."""

import copy

import pytest
import torch

from cardbench import harness, traffic, weights
from cardbench.reference import transformer as ref
from cardbench.tests.small import small

NAMES = ["granite-moe-train-4x2048", "deepseek7b-prefill-lognorm"]


def setup(name, capacity_factor=None):
    cell = small(name)
    c = copy.deepcopy(cell.config)
    if capacity_factor is not None:
        c["port"]["capacity_factor"] = capacity_factor
    cfg = harness.port_config(c).with_(remat=False)
    leaves = ref.param_leaves(c, harness.table_rows(cfg))
    tensors = weights.make(leaves, 11, "cpu")
    return c, cfg, leaves, tensors


@pytest.mark.parametrize("name,cf", [(NAMES[0], None), (NAMES[0], 0.4), (NAMES[1], None)])
def test_loss_and_gradients(name, cf):
    from repro_torch.models import registry
    from repro_torch.training import train_step

    c, cfg, leaves, tensors = setup(name, cf)
    t = small(NAMES[0]).traffic
    tokens, labels = traffic.packed_batches(t, c["vocab_size"], 5, "cpu")
    batch = {"tokens": tokens[0], "labels": labels[0]}
    assert (labels[0] == -1).any()  # the packed documents' ends are masked
    params = harness.program_params(cfg, tensors, "float32")
    loss, grads = train_step.value_and_grad(registry.get_api(cfg).loss_fn, params, batch)
    from repro_torch.models import base

    g_prog = base.tree_paths(grads)
    leaves_r = {n: tensors[n].clone().requires_grad_() for n, *_ in leaves}
    loss_r = ref.loss_fn(leaves_r, tokens[0], labels[0], ref.sizes(c), ref.F32)
    g_ref = torch.autograd.grad(loss_r, list(leaves_r.values()))
    assert abs(float(loss) - float(loss_r.detach())) <= 1e-5 * abs(float(loss_r.detach()))
    for (n, _), g in zip(leaves_r.items(), g_ref):
        scale = float(g.abs().max()) or 1.0
        assert float((g_prog[n] - g).abs().max()) <= 1e-4 * scale, n


def test_capacity_drops_happen():
    c, *_ = setup(NAMES[0], 0.4)
    z = ref.sizes(c)
    n = small(NAMES[0]).traffic["batch"] * small(NAMES[0]).traffic["seq"]
    assert ref.capacity(n, z) * z["e"] < n * z["k"]  # fewer slots than assignments


def test_prefill_logits_and_cache():
    from repro_torch.serving import serve_step

    c, cfg, leaves, tensors = setup(NAMES[1])
    params = harness.program_params(cfg, tensors, "float32")
    prompt = torch.randint(1, c["vocab_size"], (37,), generator=torch.Generator().manual_seed(3))
    pos = torch.tensor([0, 5, 36])
    logits, cache = serve_step.registry.get_api(cfg).prefill(params, {"tokens": prompt[None]})
    ((lr, kr, vr),) = ref.prefill(tensors, [prompt], [pos], c, ref.F32)
    v = c["vocab_size"]
    torch.testing.assert_close(logits[0, -1, :v], lr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache["k"][:, 0, pos], kr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache["v"][:, 0, pos], vr, rtol=1e-5, atol=1e-5)
    nxt, _ = serve_step.make_prefill(cfg)(params, {"tokens": prompt[None]})
    assert int(nxt[0]) == int(lr.argmax())


def test_weights_drawn_again_chunk_by_chunk():
    c, cfg, leaves, tensors = setup(NAMES[0])
    assert float(weights.change_norms(leaves, 11, "cpu", tensors).max()) == 0.0
    moved = dict(tensors)
    moved["ln_f.scale"] = tensors["ln_f.scale"] + 1.0
    norms = weights.change_norms(leaves, 11, "cpu", moved)
    assert float(norms[-1]) == pytest.approx(c["hidden_size"] ** 0.5)
    assert float(norms[:-1].max()) == 0.0
