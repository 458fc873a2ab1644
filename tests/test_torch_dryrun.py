"""The port's dry run on the meta device (``repro_torch.launch.dryrun``)
against the JAX package's.

* A cell's record has every key of the reference's ``lower_cell`` record
  (read from its source: importing ``repro.launch.dryrun`` would set
  ``XLA_FLAGS`` for 512 host devices in this worker), with the keys the port
  cannot compute null and named in ``not_computed``.
* ``param_bytes_global`` and ``input_bytes_global`` equal the reference's
  ``_tree_bytes`` of ``base.abstract`` and ``registry.input_specs`` for
  every arch x shape.
* The recurrences' meta-device shortcut (``dryrun.batched_scan`` in place
  of ``ssm._scan`` while a step is counted: step 0, then the other T - 1
  steps batched) counts the same FLOPs as the full loop on the CPU, forward
  and backward, and leaves ``ssm._scan`` the plain loop.
* The twins of ``tests/test_roofline_model.py``: the port's one-layer
  training-step count against ``benchmarks.roofline.model_flops`` within that
  test's 0.65-1.5, and the count linear in layers.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.roofline import model_flops
from repro.configs import ARCHS as J_ARCHS
from repro.configs import shapes as j_shapes
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import base as j_base
from repro.models import registry as j_registry
from repro_torch.configs import ARCHS, SHAPES, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention.flash_attention import flash_flops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import base, registry, ssm
from repro_torch.training import optim

REF_DRYRUN = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"
NO_COUNTS = {"flops": 0, "peak_bytes": 0, "count_s": 0.0}


def reference_record_keys() -> set:
    """The keys of the dict ``lower_cell`` returns, from the reference's source."""
    fn = next(n for n in ast.walk(ast.parse(REF_DRYRUN.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def reference_tree_bytes(tree) -> int:
    """The reference's ``dryrun._tree_bytes`` (its body; see the module
    docstring for why it is not imported)."""
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree)))


def test_record_has_the_reference_keys_at_smoke_size(tmp_path):
    """A smoke-sized training cell on the card's mesh: the reference's keys,
    the per-device bytes equal to what the arguments hold, a FLOP count and
    a peak at least the arguments."""
    cfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    shape = ShapeConfig("t", 64, 2, "train")
    rec = dryrun.dry_cell(cfg, shape, make_host_mesh("meta"), dryrun.CARD_MESH)
    assert reference_record_keys() <= rec.keys()
    assert {"lower_s", "compile_s", "collectives"} <= set(rec["not_computed"])
    assert rec["lower_s"] is rec["compile_s"] is rec["collectives"] is None
    args = dryrun.abstract_args(cfg, shape)
    pd = rec["per_device_bytes"]
    assert pd["params"] == rec["param_bytes_global"] == dryrun.tree_bytes(args["params"])
    assert pd["opt_state"] == dryrun.tree_bytes(args["opt_state"])
    assert pd["inputs"] == rec["input_bytes_global"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == pd["arguments"] == \
        pd["params"] + pd["opt_state"] + pd["inputs"]
    assert rec["cost_analysis"]["flops"] == rec["step_flops_global"] > 0
    assert rec["peak_bytes_estimate"] >= pd["arguments"]
    assert rec["fit"]["fits"] and rec["status"] == "ok"
    json.dumps(rec)  # the record is plain JSON


def test_cli_writes_ok_and_skipped_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k", "--mesh", "card"]) == 0
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k"]) == 0
    rec = json.loads((tmp_path / "h100_1x1" / "xlstm-125m__long_500k.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 1 and rec["fit"]["fits"]
    for mesh in ("single_pod_16x16", "multi_pod_2x16x16", "h100_1x1"):
        skip = json.loads((tmp_path / mesh / "tinyllama-1.1b__long_500k.json").read_text())
        assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_global_bytes_equal_the_reference(arch):
    """param_bytes_global and input_bytes_global of every shape, on both
    production meshes (the meta step is not run: its counts are given)."""
    for name, shape in SHAPES.items():
        want_p = reference_tree_bytes(j_base.abstract(j_registry.get_api(J_ARCHS[arch]).specs()))
        want_i = reference_tree_bytes(j_registry.input_specs(J_ARCHS[arch], j_shapes.SHAPES[name]))
        for mesh_name, mesh in (("single_pod_16x16", make_production_mesh()),
                                ("multi_pod_2x16x16", make_production_mesh(multi_pod=True))):
            rec = dryrun.lower_cell(arch, name, mesh, mesh_name, counts=NO_COUNTS)
            assert (rec["param_bytes_global"], rec["input_bytes_global"]) == (want_p, want_i)
            assert rec["devices"] == mesh.size and rec["cost_analysis"] is None
            assert 0 < rec["per_device_bytes"]["params"] <= want_p


def test_per_device_bytes_on_a_production_mesh():
    """tinyllama-1.1b's training cell on 16x16 by hand: the vocab, heads and
    ff dims split 16 ways, kv_heads (4) and embed replicated; the moments
    likewise in f32; tokens and labels split over "data"."""
    cfg = ARCHS["tinyllama-1.1b"]
    rec = dryrun.lower_cell(cfg.arch, "train_4k", make_production_mesh(), "single_pod_16x16",
                            counts=NO_COUNTS)
    d, v, ff, hk = cfg.d_model, 32000, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    vp = -(-v // 128) * 128  # the padded vocab
    layer = d * d // 16 + 2 * d * hk + d * d // 16 + 3 * d * ff // 16 + 2 * d
    n = vp * d // 16 + cfg.n_layers * layer + d
    pd = rec["per_device_bytes"]
    assert pd["params"] == 2 * n and pd["opt_state"] == 8 * n + 4
    assert pd["inputs"] == 2 * 4 * 256 * 4096 // 16


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_recurrence_shortcut_counts_the_full_loop(arch, kind):
    """A smoke-sized step on the meta device (step 0, then T - 1 steps as
    one) and the same step on the CPU (the loop, T steps): equal FLOPs."""
    cfg = smoke_variant(ARCHS[arch])
    shape = ShapeConfig("s", 24, 2, kind)
    counted = dryrun.count_step(cfg, shape)["flops"]
    params = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0))
    inputs = {k: torch.zeros(v.shape, dtype=v.dtype)
              for k, v in dryrun.abstract_args(cfg, shape)["inputs"].items()}
    real = {"params": params, "inputs": inputs,
            "opt_state": optim.init(params) if kind == "train" else None}
    with FlopCounterMode(display=False) as fc:
        dryrun.run_step(cfg, shape, real)
    assert counted == fc.get_total_flops() > 0
    assert ssm._scan is not dryrun.batched_scan


def test_flash_counted_by_its_shapes_on_meta():
    """On the meta device a windowless model's attention is the flash
    kernel's stand-in, counted by flash_flops (causal pairs only), as the
    kernel is on the card."""
    cfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    shape = ShapeConfig("p", 96, 2, "prefill")
    args = dryrun.abstract_args(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        dryrun.run_step(cfg, shape, args)
    got = fc.get_flop_counts()["Global"][torch.ops.repro_torch.flash_attention_fwd]
    q = (2, 96, cfg.n_heads, cfg.head_dim)
    assert got == cfg.n_layers * flash_flops(q, q, 96, True)
    assert flash_flops(q, q, 96, True) == 2 * (2 * cfg.head_dim) * 2 * cfg.n_heads * 96 * 97 // 2
    assert flash_flops((3, 5, 8), (3, 7, 8), 7, True) == 2 * 16 * 3 * (1 + 2 + 3 + 4 + 5)
    assert flash_flops((3, 9, 8), (3, 7, 8), 7, True) == 2 * 16 * 3 * (28 + 2 * 7)


SMALL_TRAIN = ShapeConfig("t", 512, 8, "train")


def _train_flops(cfg) -> int:
    return dryrun.count_step(cfg, SMALL_TRAIN)["flops"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-7b"])
def test_counted_flops_match_the_analytic_model_one_layer(arch):
    """Twin of test_analytic_flops_matches_compiled_one_layer: the analytic
    model within 0.65-1.5 of the port's own count (which counts the flash
    forward by its kept pairs and the plain attention's backward in full)."""
    counted = _train_flops(ARCHS[arch].with_(n_layers=1, remat=False))
    analytic = model_flops(J_ARCHS[arch].with_(n_layers=1, remat=False),
                           JShapeConfig("t", 512, 8, "train"))["total"]
    assert counted > 0
    ratio = analytic / counted
    assert 0.65 < ratio < 1.5, (analytic, counted, ratio)


def test_counted_flops_scale_linearly_in_layers():
    """Twin of test_flops_scale_linearly_in_layers_analytically: each layer
    adds the same count, so 1, 2 and 3 layers lie on a line."""
    cfg = ARCHS["tinyllama-1.1b"]
    f1, f2, f3 = (_train_flops(cfg.with_(n_layers=n)) for n in (1, 2, 3))
    assert f3 - f2 == f2 - f1 > 0


def test_live_bytes_counts_what_softmax_allocates_inside():
    """The tracker's peak holds softmax's copy of a non-contiguous input and
    its backward's product and copy of a non-contiguous gradient (seen on
    the card, not through dispatch), and frees what dies."""
    aten = torch.ops.aten
    x = torch.empty(64, 32, device="meta").t()  # (32, 64), rows not laid out together
    n = x.numel() * 4
    assert dryrun.inside_bytes(aten._softmax.default, (x, -1, False)) == n
    assert dryrun.inside_bytes(aten._softmax.default, (x.contiguous(), -1, False)) == 0
    out = torch.empty(32, 64, device="meta")
    assert dryrun.inside_bytes(aten._softmax_backward_data.default,
                               (x, out, -1, torch.float32)) == 2 * n
    assert dryrun.inside_bytes(aten._softmax_backward_data.default,
                               (out, out, -1, torch.float32)) == n
    live = dryrun.LiveBytes()
    live.track(x)
    with live:
        y = torch.softmax(x, dim=-1)
        assert live.live == 2 * n
        del y
    assert live.live == n and live.peak == 3 * n  # x, y, and x's copy inside
