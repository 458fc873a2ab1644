"""Tensor parallelism of the port's training step over a mesh's "model" axis
against the JAX reference's GSPMD step: the parameters placed by the
sharding rules (``sharding.shard_params``), the products split over the
attention heads, the MLP width, the vocabulary and the experts
(``parallel/tensor.py``, ``models/layers.py``, ``models/transformer.py``,
``models/moe.py``), the clipping norm over the mesh (``optim.global_norm``),
``launch.train.run(mesh=)``, checkpoints across meshes, and each rank's
bytes against the dry run's per-device bytes.

The reference runs once for the module in a subprocess with four fake CPU
devices (``tests/torch_tp_ref.py``): its parameters placed by
``sharding.param_shardings`` with ``jax.device_put``, the batch over the
data axis, ``jax.jit(jax.value_and_grad(loss_fn))`` under ``jax.set_mesh``.
The port runs on 4, 2 and 3 gloo ranks spawned on the CPU
(``tests/torch_parallel_workers.py``) while it does. Parameters and batches
are drawn by numpy and cross over through ``convert``; on a mesh with two
data ranks each takes its rows and the loss and gradients are averaged over
them, as the step averages them.

Cases (data, model): smoke tinyllama-1.1b at (1, 4) (4 heads over 2 KV
heads: one query head a rank, the KV heads whole), (2, 2) and (1, 2);
qwen1.5-110b (qkv bias) at (1, 2) and (1, 4) (the whole KV weights' and
biases' cotangents summed over "model"), internvl2-76b (VLM) at (1, 2);
granite-moe at
(1, 4) without ``moe_hints`` (the experts split, ``moe_apply``), with them
(``moe_apply_ep``), and with 6 experts (their FFN width split); tinyllama
with ``xent_chunk``; deepseek-v3 without MLA (shared expert, dense-first
layer, MTP); 6 heads over 2 KV heads on (1, 3), where a rank's two query
heads straddle two KV groups (expanded to one KV head each), and the
vocabulary and MLP width do not divide 3 (whole); tinyllama in bf16; and
granite-moe at capacity factor 0.5 (tokens drop) on (2, 1) and (2, 2)
without ``moe_hints``, where ``moe_apply`` takes the capacity, the drop
order and the aux loss over the global batch, as the reference's GSPMD
program does (with each data rank's own, the loss missed by 3.5e-4 and
5.4e-4 and a gradient leaf by up to 1.05 and 0.90 of its largest entry).
The (2, 1) MoE step is also held against one process on the whole batch,
at 1 and 2 microbatches (``train.data_rows``), by the same tolerances.

Tolerances, each with its reason:
- f32 loss: rtol 1e-6; each gradient leaf: 1e-5 of its largest entry. The
  split products and the all-reduces sum in another order than one device,
  as GSPMD's do (measured over the f32 cases: loss <= 2.3e-7, gradients
  <= 3.6e-6 of the leaf's largest entry; the two data-axis MoE cases 7.6e-8
  and 1.9e-6).
- grad norm: rtol 1e-6 (the blocks' squares summed over "model"; measured
  <= 2.5e-7, the data-axis MoE cases <= 4.3e-7).
- bf16 (parameters and ``dtype``): the loss only, rtol 2e-3, as
  tests/test_torch_moe.py holds the bf16 model (the residual stream rounded
  to bf16 after every layer, an ulp apart in the two frameworks; measured
  7.5e-5).
- ``train.run`` at (2, 2), ten f32 steps, against one process: as
  tests/test_torch_runtime.py's ``TestRunOnAMesh`` holds the data-parallel
  run, losses rtol 1e-5, parameters rtol 1e-5 plus atol 1e-5 (measured:
  losses 1.5e-7, parameters 8.1e-6 absolute, where AdamW's step of an entry
  whose gradient nearly cancels takes the sums' order).
- checkpoints across meshes: bit for bit.
- xlstm's ``train.run`` on (1, 2), placed by the rules, against one
  process, three steps at lr 2e-3 under ``train.run``'s warmup of 20 (steps
  of 1e-4, 2e-4 and 3e-4): losses rtol 1e-5, parameters rtol 1e-5 plus atol
  5e-5, three times the one entry measured apart. mLSTM's ``b_if`` gradient
  is ill-conditioned (ROADMAP queue 3), and AdamW steps an entry whose
  gradient nearly cancels by an amount that the sums' order moves
  (measured: losses 7.6e-8, parameters 1.65e-5 absolute, one entry of layer
  0's ``b_if``; every other leaf within the (2, 2) run's 1e-5).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import base, registry
from repro_torch.training import optim

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16  # each case's batch (over two data ranks) and text tokens
LOSS_RTOL, GRAD_TOL, NORM_RTOL, BF16_LOSS_RTOL = 1e-6, 1e-5, 1e-6, 2e-3


def _case(name, arch, mesh, dtype="float32", **overrides):
    return dict(name=name, arch=arch, overrides=overrides, mesh=list(mesh), dtype=dtype)


CASES = [
    _case("tinyllama_1x4", "tinyllama-1.1b", (1, 4)),
    _case("tinyllama_2x2", "tinyllama-1.1b", (2, 2)),
    _case("tinyllama_1x2", "tinyllama-1.1b", (1, 2)),
    _case("qwen_1x2", "qwen1.5-110b", (1, 2)),
    _case("qwen_1x4", "qwen1.5-110b", (1, 4)),
    _case("internvl2_1x2", "internvl2-76b", (1, 2)),
    _case("granite_1x4", "granite-moe-3b-a800m", (1, 4)),
    _case("granite_hints_1x4", "granite-moe-3b-a800m", (1, 4), moe_hints=True),
    _case("granite_e6_1x4", "granite-moe-3b-a800m", (1, 4), n_experts=6),
    _case("tinyllama_xent_chunk_1x4", "tinyllama-1.1b", (1, 4), xent_chunk=8),
    _case("deepseek_v3_no_mla_1x4", "deepseek-v3-671b", (1, 4), mla=False),
    _case("heads6_kv2_1x3", "tinyllama-1.1b", (1, 3), n_heads=6, n_kv_heads=2),
    _case("tinyllama_bf16_1x4", "tinyllama-1.1b", (1, 4), dtype="bfloat16"),
    _case("granite_cf05_2x1", "granite-moe-3b-a800m", (2, 1), capacity_factor=0.5),
    _case("granite_cf05_2x2", "granite-moe-3b-a800m", (2, 2), capacity_factor=0.5),
]
F32_CASES = [c["name"] for c in CASES if c["dtype"] == "float32"]
# the MoE case whose (2, 1) step is held against one process on the whole batch
GLOBAL_CASE = next(c for c in CASES if c["name"] == "granite_cf05_2x1")
GLOBAL_MICROBATCHES = (1, 2)
# leaves each rank holds a block of: the embedding and, per layer, the split
# products (tinyllama at tp 4: wq, wo and the MLP's three; at tp 2 wk and wv too)
N_SPLIT = {"tinyllama_1x4": 1 + 4 * 5, "tinyllama_1x2": 1 + 4 * 7, "heads6_kv2_1x3": 4 * 2,
           "granite_1x4": 1 + 4 * 5, "granite_e6_1x4": 1 + 4 * 5}
# the archs whose per-rank bytes are held to the dry run's, on (1, 4) and (2, 2)
BYTES_ARCHS = [("tinyllama-1.1b", {}), ("qwen1.5-110b", {}), ("internvl2-76b", {}),
               ("granite-moe-3b-a800m", {}), ("granite-moe-3b-a800m", {"n_experts": 6})]
BYTES_SHAPES = [(1, 4), (2, 2)]
TINY_RUN = dict(arch="tinyllama-1.1b", smoke=True, batch=4, seq=32, lr=2e-3, log_every=1,
                steps=10)
XLSTM_RUN = dict(arch="xlstm-125m", smoke=True, batch=2, seq=16, lr=2e-3, log_every=1, steps=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and each world's per-rank results."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inputs = {c["name"]: W.tp_inputs(c, seed, B, S) for seed, c in enumerate(CASES)}
    flat = {"cases": np.asarray(json.dumps(CASES))}
    for name, inp in inputs.items():
        flat.update({f"{name}/p/{k}": v for k, v in base.tree_paths(inp["params"]).items()})
        flat.update({f"{name}/{k}": v for k, v in inp.items() if k != "params"})
    np.savez(tmp / "in.npz", **flat)
    none_tree = W.one_process_ckpt(tmp / "from_none")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_tp_ref.py"),
                             str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        four = W.spawn("jobs", 4, tmp / "four", ("tp_cases", (CASES, inputs)),
                       *[("placement_bytes", (BYTES_ARCHS, shape)) for shape in BYTES_SHAPES],
                       ("train_runs", ([((2, 2), TINY_RUN, True)],)),
                       ("ckpt_across_meshes", ((1, 4), tmp / "from_1x4", tmp / "from_none")))
        two = W.spawn("jobs", 2, tmp / "two", ("tp_cases", (CASES, inputs)),
                      ("train_runs", ([((1, 2), XLSTM_RUN, True)],)),
                      ("global_batch_steps", (GLOBAL_CASE, inputs[GLOBAL_CASE["name"]],
                                              GLOBAL_MICROBATCHES)))
        three = W.spawn("tp_cases", 3, tmp / "three", CASES, inputs)
        log, _ = proc.communicate(timeout=W.SPAWN_TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    cases = {}
    for world in (four, two):
        for name in world[0][0]:
            cases[name] = [r[0][name] for r in world]
    for name in three[0]:
        cases[name] = [r[name] for r in three]
    return dict(ref=dict(np.load(tmp / "out.npz")), cases=cases, tmp=tmp, none_tree=none_tree,
                bytes={shape: [r[1 + i] for r in four] for i, shape in enumerate(BYTES_SHAPES)},
                run_2x2=[r[3][0] for r in four], ckpt=[r[4] for r in four],
                xlstm=[r[1][0] for r in two], global_steps=[r[2] for r in two],
                inputs=inputs)


@pytest.fixture
def one_thread():
    """One intra-op thread for the one-process runs, as the spawned ranks
    have (tests/test_torch_runtime.py: a parallel test run shares the
    machine's cores among its workers)."""
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
    assert sorted(ranks[0]["grads"]) == sorted(want)
    gaps = {}
    for k, w in want.items():
        got = ranks[0]["grads"][k]
        assert got.shape == w.shape, k
        gaps[k] = _rel(got, w)
        for r in ranks[1:]:  # gathered whole, the same on every rank
            np.testing.assert_array_equal(r["grads"][k], got, err_msg=k)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])


@pytest.mark.parametrize("name", F32_CASES)
def test_grad_norm_over_the_mesh_matches_reference(runs, name):
    want = float(runs["ref"][f"{name}/grad_norm"])
    for r in runs["cases"][name]:
        assert abs(r["grad_norm"] - want) <= NORM_RTOL * want, (r["grad_norm"], want)


@pytest.mark.parametrize("name", sorted(N_SPLIT))
def test_the_rules_split_the_expected_leaves(runs, name):
    assert all(r["n_split"] == N_SPLIT[name] for r in runs["cases"][name])


@pytest.mark.parametrize("shape", BYTES_SHAPES)
@pytest.mark.parametrize("arch,overrides", BYTES_ARCHS)
def test_rank_bytes_equal_the_dry_runs_per_device_bytes(runs, arch, overrides, shape):
    """Each rank's parameters and AdamW state, as ``train.run`` places them,
    take the bytes the dry run reports per device for that mesh (the specs'
    dtypes; the state's step count on every rank)."""
    cfg = smoke_variant(ARCHS[arch]).with_(**overrides)
    cell = ShapeConfig("tp_test", S, B, "train")
    # the per-device bytes come from the rules alone: no meta step is counted
    rec = dryrun.dry_cell(cfg, cell, Mesh(("data", "model"), shape), f"{shape[0]}x{shape[1]}",
                          counts=dict(flops=0, peak_bytes=0, count_s=0.0))
    whole = dryrun.tree_bytes(dryrun.abstract_args(cfg, cell)["params"])
    for r in runs["bytes"][shape]:
        got = r[arch, tuple(sorted(overrides.items()))]
        assert got["params"] == rec["per_device_bytes"]["params"] < whole
        assert got["opt_state"] == rec["per_device_bytes"]["opt_state"]


def test_train_run_on_2x2_matches_one_process(runs, one_thread):
    """Ten f32 steps of ``train.run`` on (2, 2) against one process; each
    step averages over the two data ranks once."""
    W.assert_run_matches(runs["run_2x2"], TINY_RUN)
    assert all(r["mean_over_calls"] == TINY_RUN["steps"] for r in runs["run_2x2"])


def test_checkpoint_saved_on_1x4_restores_without_a_mesh(runs):
    cfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    like = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0))
    like = (like, optim.init(like))
    _, tree, manifest = CheckpointManager(runs["tmp"] / "from_1x4").restore_latest(
        like, device="cpu")
    assert manifest["step"] == 1
    got, want = W.host(tree), runs["ckpt"][0]["saved"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for r in runs["ckpt"][1:]:  # every rank gathered the same tree
        for k, v in want.items():
            np.testing.assert_array_equal(r["saved"][k], v, err_msg=k)


def test_checkpoint_saved_without_a_mesh_restores_on_1x4(runs):
    want = runs["none_tree"]
    for r in runs["ckpt"]:
        assert r["restored"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)
    # each rank restored its blocks only: less than the whole tree
    whole = sum(v.nbytes for v in want.values())
    assert all(r["restored_bytes"] < whole for r in runs["ckpt"])


def test_xlstm_on_a_model_axis_of_two_equals_no_mesh(runs, one_thread):
    """xlstm (ssm) placed by the rules on (1, 2), its split leaves gathered at
    their use or split after the scans (models/ssm.py), against the run
    without a mesh: three f32 steps, the losses as the (2, 2) run's, the
    parameters within atol 5e-5, three times mLSTM's ``b_if`` entry measured
    1.65e-5 apart (module docstring)."""
    W.assert_run_matches(runs["xlstm"], XLSTM_RUN, params_atol=5e-5)


@pytest.mark.parametrize("microbatches", GLOBAL_MICROBATCHES)
def test_moe_step_over_two_data_ranks_equals_one_process(runs, one_thread, microbatches):
    """Smoke granite at capacity factor 0.5 (tokens drop): one f32
    ``make_train_step`` step on the (2, 1) mesh, each rank on its rows
    (``train.data_rows``), against one process on the whole batch. The MoE
    layers' capacity, drops and aux loss are the global batch's (of each
    microbatch's), as the reference's GSPMD step gives against its one
    device; held as the cases against the reference are."""
    cfg = W.tp_cfg(GLOBAL_CASE)
    inputs = runs["inputs"][GLOBAL_CASE["name"]]
    params = convert.params_from_numpy(inputs["params"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "params"}
    want = W.step_grads(cfg, params, batch, microbatches)
    for r in (ranks[microbatches] for ranks in runs["global_steps"]):
        assert abs(r["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(r["grad_norm"] - want["grad_norm"]) <= NORM_RTOL * want["grad_norm"]
        assert sorted(r["grads"]) == sorted(want["grads"])
        for k, w in want["grads"].items():
            assert _rel(r["grads"][k], w) <= GRAD_TOL, (k, _rel(r["grads"][k], w))
