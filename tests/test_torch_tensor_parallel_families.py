"""Tensor parallelism over a mesh's "model" axis for MLA (deepseek-v3), the
encoder-decoder (whisper), xLSTM (ssm) and the Mamba2 hybrid (zamba2)
against the JAX reference's GSPMD step, as
tests/test_torch_tensor_parallel.py holds the dense, VLM and MoE families:
the recurrent blocks gather the leaves whose blocks are no unit of work
(models/ssm.py), MLA splits its heads, whisper its three attentions.

The reference runs once for the module in a subprocess with four fake CPU
devices (``tests/torch_tp_ref.py``): its parameters placed by
``sharding.param_shardings`` with ``jax.device_put``, the batch over the
data axis, ``jax.jit(jax.value_and_grad(loss_fn))`` under ``jax.set_mesh``.
The port runs on 2 and 4 gloo ranks spawned on the CPU
(``tests/torch_parallel_workers.py``) while it does. Parameters and batches
are drawn by numpy and cross over through ``convert``.

Cases (data, model), the smoke variants in f32: xlstm-125m at (1, 2) and
(1, 4) (mLSTM's ``w_up``/``wq``/``wk``/``wv`` and sLSTM's ``w``/``r``
gathered, ``gn``/``w_down`` row-parallel after the scan; the idle block of
each layer zero on each rank's block); zamba2-2.7b at (1, 2) and (2, 2)
(Mamba2's ``in_proj`` gathered, the shared block's attention and MLP split
and applied twice); whisper-medium at (1, 2) and (1, 4) (encoder, decoder
and cross-attention over the rank's heads, GELU MLPs, vocabulary);
deepseek-v3-671b at (1, 2), and at (1, 4) without and with ``moe_hints``
(MLA over the rank's heads, dense-first layer, split experts or
``moe_apply_ep``, shared expert, MTP); and whisper in bf16 at (1, 2).

Tolerances, each with its reason:
- f32 loss: rtol 1e-6; each gradient leaf: 1e-5 of its largest entry; grad
  norm: rtol 1e-6. The split products and the all-reduces sum in another
  order than one device, as GSPMD's do (measured over these cases: loss
  <= 1.2e-7, gradients <= 5.7e-6 of the leaf's largest entry, norm <=
  7.0e-7; the mLSTM layers need none of their looser bound of
  tests/test_torch_xlstm.py here).
- Mamba2's ``d_skip``: 1e-3 of its largest entry, its bound in
  tests/test_torch_hybrid.py and ROADMAP.md (the group norm after the skip
  is blind to its scale: moving every parameter of the reference by one ulp
  moves this gradient by 2.5e-4 of its largest; measured here 4.3e-4).
- bf16 (parameters and ``dtype``): the loss only, rtol 2e-3, as
  tests/test_torch_moe.py holds bf16 models (measured 7.1e-5).
- ``train.run`` on (1, 2) against one process (zamba2 here; xlstm in
  tests/test_torch_tensor_parallel.py): losses rtol 1e-5, parameters rtol
  1e-5 plus atol 1e-5, as the (2, 2) run there is held (measured: losses
  7.6e-8, parameters 5.0e-6 absolute).
- checkpoints across meshes: bit for bit.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import base, registry
from repro_torch.parallel import sharding
from repro_torch.training import optim

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16  # each case's batch (over two data ranks) and text tokens
LOSS_RTOL, GRAD_TOL, NORM_RTOL, BF16_LOSS_RTOL = 1e-6, 1e-5, 1e-6, 2e-3
# the recurrent leaf held looser, at its bound in tests/test_torch_hybrid.py
LEAF_TOL = {"mamba_layers.d_skip": 1e-3}
XLSTM, ZAMBA, WHISPER, DEEPSEEK = ("xlstm-125m", "zamba2-2.7b", "whisper-medium",
                                   "deepseek-v3-671b")


def _case(name, arch, mesh, dtype="float32", **overrides):
    return dict(name=name, arch=arch, overrides=overrides, mesh=list(mesh), dtype=dtype)


CASES = [
    _case("xlstm_1x2", XLSTM, (1, 2)),
    _case("xlstm_1x4", XLSTM, (1, 4)),
    _case("zamba2_1x2", ZAMBA, (1, 2)),
    _case("zamba2_2x2", ZAMBA, (2, 2)),
    _case("whisper_1x2", WHISPER, (1, 2)),
    _case("whisper_1x4", WHISPER, (1, 4)),
    _case("deepseek_v3_1x2", DEEPSEEK, (1, 2)),
    _case("deepseek_v3_1x4", DEEPSEEK, (1, 4)),
    _case("deepseek_v3_hints_1x4", DEEPSEEK, (1, 4), moe_hints=True),
    _case("whisper_bf16_1x2", WHISPER, (1, 2), dtype="bfloat16"),
]
F32_CASES = [c["name"] for c in CASES if c["dtype"] == "float32"]
# the leaves the rules split at (1, 2), counted as the reference stacks its
# layers (one leaf per stacked group), and each rank's count of the port's
# per-layer leaves: the embedding plus, per layer of 4, mLSTM's 6 and sLSTM's
# 2 (xlstm); per Mamba2 layer 3, and the shared block's 7 (zamba2); per
# encoder layer 6, per decoder layer 10 (whisper); per MLA attention 3, the
# dense-first layer's MLP 3, per MoE layer 3 experts and 3 shared, MTP's
# block 6 (deepseek-v3)
N_SPLIT = {"xlstm_1x2": (9, 1 + 4 * 8), "zamba2_1x2": (11, 1 + 4 * 3 + 7),
           "whisper_1x2": (17, 1 + 2 * 6 + 4 * 10),
           "deepseek_v3_1x2": (22, 1 + 6 + 3 * 9 + 6)}
BYTES_ARCHS = [XLSTM, ZAMBA, WHISPER, DEEPSEEK]
BYTES_SHAPES = [(1, 4), (2, 2)]
REF_PROCS = 2  # the reference's processes, each a share of the cases
ZAMBA_RUN = dict(arch=ZAMBA, smoke=True, batch=2, seq=16, lr=2e-3, log_every=1, steps=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and each world's per-rank results."""
    tmp = tmp_path_factory.mktemp("tensor_parallel_families")
    inputs = {c["name"]: W.tp_inputs(c, 100 + seed, B, S) for seed, c in enumerate(CASES)}
    none_tree = W.one_process_ckpt(tmp / "from_none", ZAMBA)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for i in range(REF_PROCS):  # the reference's compiles take most of the time: split them
        part = CASES[i::REF_PROCS]
        flat = {"cases": np.asarray(json.dumps(part))}
        for c in part:
            name, inp = c["name"], inputs[c["name"]]
            flat.update({f"{name}/p/{k}": v for k, v in base.tree_paths(inp["params"]).items()})
            flat.update({f"{name}/{k}": v for k, v in inp.items() if k != "params"})
        np.savez(tmp / f"in{i}.npz", **flat)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_tp_ref.py"), str(tmp / f"in{i}.npz"),
             str(tmp / f"out{i}.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        four = W.spawn("jobs", 4, tmp / "four", ("tp_cases", (CASES, inputs)),
                       *[("placement_bytes", ([(a, {}) for a in BYTES_ARCHS], shape))
                         for shape in BYTES_SHAPES])
        two = W.spawn("jobs", 2, tmp / "two", ("tp_cases", (CASES, inputs)),
                      ("train_runs", ([((1, 2), ZAMBA_RUN, True)],)),
                      ("ckpt_across_meshes", ((1, 2), tmp / "from_1x2", tmp / "from_none",
                                              ZAMBA)))
        logs = [proc.communicate(timeout=W.SPAWN_TIMEOUT_S)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
    ref = {}
    for i in range(REF_PROCS):
        ref.update(np.load(tmp / f"out{i}.npz"))
    cases = {}
    for world in (four, two):
        for name in world[0][0]:
            cases[name] = [r[0][name] for r in world]
    return dict(ref=ref, cases=cases, tmp=tmp, none_tree=none_tree,
                bytes={shape: [r[1 + i] for r in four] for i, shape in enumerate(BYTES_SHAPES)},
                zamba_run=[r[1][0] for r in two], ckpt=[r[2] for r in two])


@pytest.fixture
def one_thread():
    """One intra-op thread for the one-process runs, as the spawned ranks
    have."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_loss_matches_reference(runs, name):
    ranks = runs["cases"][name]
    want = float(runs["ref"][f"{name}/loss"])
    rtol = LOSS_RTOL if name in F32_CASES else BF16_LOSS_RTOL
    assert abs(ranks[0]["loss"] - want) <= rtol * abs(want), (ranks[0]["loss"], want)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)  # replicated over the mesh


@pytest.mark.parametrize("name", F32_CASES)
def test_gradients_match_reference(runs, name):
    ranks = runs["cases"][name]
    pre = f"{name}/g/"
    want = {k[len(pre):]: v for k, v in runs["ref"].items() if k.startswith(pre)}
    got = ranks[0]["grads"]  # in the reference's layout: each layer group stacked
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert _rel(got[k], w) <= LEAF_TOL.get(k, GRAD_TOL), (k, _rel(got[k], w))
        for r in ranks[1:]:  # gathered whole, the same on every rank
            np.testing.assert_array_equal(r["grads"][k], got[k], err_msg=k)


@pytest.mark.parametrize("name", F32_CASES)
def test_grad_norm_over_the_mesh_matches_reference(runs, name):
    want = float(runs["ref"][f"{name}/grad_norm"])
    for r in runs["cases"][name]:
        assert abs(r["grad_norm"] - want) <= NORM_RTOL * want, (r["grad_norm"], want)


@pytest.mark.parametrize("name", sorted(N_SPLIT))
def test_the_rules_split_the_expected_leaves(runs, name):
    stacked, per_layer = N_SPLIT[name]
    for r in runs["cases"][name]:
        assert r["n_split"] == per_layer == len(r["split_paths"])
        assert len({re.sub(r"\.\d+\.", ".", p) for p in r["split_paths"]}) == stacked


@pytest.mark.parametrize("shape", BYTES_SHAPES)
@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_rank_bytes_equal_the_dry_runs_per_device_bytes(runs, arch, shape):
    """Each rank's parameters and AdamW state, as ``train.run`` places them,
    take the bytes the dry run reports per device for that mesh."""
    cfg = smoke_variant(ARCHS[arch])
    cell = ShapeConfig("tp_test", S, B, "train")
    rec = dryrun.dry_cell(cfg, cell, Mesh(("data", "model"), shape), f"{shape[0]}x{shape[1]}",
                          counts=dict(flops=0, peak_bytes=0, count_s=0.0))
    whole = dryrun.tree_bytes(dryrun.abstract_args(cfg, cell)["params"])
    for r in runs["bytes"][shape]:
        got = r[arch, ()]
        assert got["params"] == rec["per_device_bytes"]["params"] < whole
        assert got["opt_state"] == rec["per_device_bytes"]["opt_state"]


@pytest.mark.parametrize("name", F32_CASES)
def test_rank_gradient_bytes_equal_the_dry_runs_per_device_bytes(runs, name):
    """A step's gradients on each rank are its blocks, an idle block's zeros
    included: the bytes the dry run's rules give one device for the f32
    parameters on the case's mesh."""
    case = next(c for c in CASES if c["name"] == name)
    cfg = W.tp_cfg(case)
    specs = registry.get_api(cfg).specs()
    mesh = Mesh(("data", "model"), tuple(case["mesh"]))
    want = dryrun.shard_bytes(base.abstract(specs, torch.float32),
                              sharding.param_shardings(cfg, specs, mesh))
    whole = dryrun.tree_bytes(base.abstract(specs, torch.float32))
    assert all(r["grad_bytes"] == want < whole for r in runs["cases"][name])


def test_train_run_on_1x2_matches_one_process(runs, one_thread):
    """Three f32 steps of zamba2's ``train.run`` on (1, 2) against one
    process."""
    W.assert_run_matches(runs["zamba_run"], ZAMBA_RUN)


def test_one_data_rank_makes_no_mean_over_the_data_axes(runs):
    """On (1, 2) the data axes hold one rank: the step skips their mean,
    which would copy every gradient into an f32 buffer for nothing."""
    assert all(r["mean_over_calls"] == 0 for r in runs["zamba_run"])


def test_checkpoint_saved_on_1x2_restores_without_a_mesh(runs):
    cfg = smoke_variant(ARCHS[ZAMBA])
    like = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0))
    like = (like, optim.init(like))
    _, tree, manifest = CheckpointManager(runs["tmp"] / "from_1x2").restore_latest(
        like, device="cpu")
    assert manifest["step"] == 1
    got, want = W.host(tree), runs["ckpt"][0]["saved"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_saved_without_a_mesh_restores_on_1x2(runs):
    want = runs["none_tree"]
    for r in runs["ckpt"]:
        assert r["restored"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)
    whole = sum(v.nbytes for v in want.values())
    assert all(r["restored_bytes"] < whole for r in runs["ckpt"])
