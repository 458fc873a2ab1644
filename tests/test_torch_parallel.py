"""The port's parallel layer at runtime against the JAX reference's on fake
devices: ``moe.moe_apply_ep`` (values and gradients), ``moe._moe_ffn``'s
choice of dispatch, ``compression.compressed_allreduce``, and the
collectives under them (``parallel/collectives.py``).

The reference runs once for the module in a subprocess that gives JAX four
CPU devices (``tests/torch_parallel_ref.py``: ``XLA_FLAGS`` must be set
before JAX starts, and this process's JAX has one). The port runs on 4 and
2 gloo ranks spawned on the CPU (``tests/torch_parallel_workers.py``), one
world after the other while the reference's process runs. Inputs are drawn
by numpy; the MoE cases are f32.

Meshes (data, model): (1, 4), (2, 2) and (1, 2). On a mesh with two data
ranks each rank passes its rows of x, its loss holds its rows' share, and
the parameters' gradients are averaged over the data ranks, as
``launch.train.run``'s step averages them (``torch_parallel_workers.ep_case``).

Tolerances, each with its reason (``y``, ``gx`` and every gradient leaf
relative to the largest entry of the reference's tensor):
- y: 1e-6; aux: atol 1e-7 (aux is about 0.01). The same products and sums
  in the same order, but for torch's and XLA's matmuls and the mesh means'
  reduction order (measured: y <= 2.7e-7, aux <= 1.9e-9, two ulps).
- gradients: 1e-5 (measured <= 4.3e-7: the gradients' cross-rank sums and
  the expert products' reductions in another order).
- compressed all-reduce: codes and scales exact, the mean rtol 1e-6. The
  residual within one rounding of ``q * scale``: the reference runs it
  jitted inside ``shard_map``, where XLA fuses ``x - q * scale`` into one
  FMA; the port rounds the product first, as the eager reference does
  (``tests/test_torch_runtime.py`` holds ``compress`` to it).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from repro_torch.launch import mesh as M
from repro_torch.models import moe
from repro_torch.parallel import compression as comp

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16  # the EP cases' batch and sequence: B splits over 2 data ranks, S over 4 model ranks
Y_TOL, AUX_ATOL, GRAD_TOL, MEAN_RTOL = 1e-6, 1e-7, 1e-5, 1e-6


def _shape_key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and each world's per-rank results."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = {v: W.numpy_inputs(W.moe_cfg(v), seed, B, S)
              for seed, v in enumerate(W.VARIANTS)}
    rng = np.random.default_rng(7)
    comp_in = dict(x=(rng.standard_normal((4, 33, 7)) * 3).astype(np.float32),
                   err=(rng.standard_normal((4, 33, 7)) * 0.01).astype(np.float32))
    flat = {f"{v}/{k}": a for v, d in inputs.items() for k, a in d.items()}
    flat.update({f"compressed/{k}": a for k, a in comp_in.items()})
    flat.update(mesh_shapes=np.asarray(W.MESH_SHAPES), variants=np.asarray(W.VARIANTS),
                select_cases=np.asarray(W.SELECT_CASES))
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ref.py"),
                             str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        four = W.spawn("jobs", 4, tmp / "four",
                       ("ep_cases", ([(1, 4), (2, 2)], W.VARIANTS, inputs)),
                       ("compressed_case", (comp_in,)), ("mesh_layout", ()))
        two = W.spawn("ep_cases", 2, tmp / "two", [(1, 2)], W.VARIANTS, inputs)
        log, _ = proc.communicate(timeout=W.SPAWN_TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    return dict(ref=dict(np.load(tmp / "out.npz")), four=[r[0] for r in four], two=two,
                comp=[r[1] for r in four], layout=[r[2] for r in four])


def _port(runs, shape):
    return runs["four"] if shape[0] * shape[1] == 4 else runs["two"]


CASES = [(shape, v) for shape in W.MESH_SHAPES for v in W.VARIANTS]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape,variant", CASES)
def test_moe_apply_ep_values_match_reference(runs, shape, variant):
    dp = shape[0]
    key = f"{_shape_key(shape)}/{variant}"
    want_y, want_aux = runs["ref"][f"{key}/y"], runs["ref"][f"{key}/aux"]
    ranks = [r[(shape, variant)] for r in _port(runs, shape)]
    y = np.concatenate([ranks[d * shape[1]]["y"] for d in range(dp)])
    assert y.shape == want_y.shape
    assert _rel(y, want_y) <= Y_TOL
    for d in range(dp):  # every model rank holds its data rank's whole output
        for m in range(shape[1]):
            np.testing.assert_array_equal(ranks[d * shape[1] + m]["y"], ranks[d * shape[1]]["y"])
    for r in ranks:
        np.testing.assert_allclose(r["aux"], want_aux, rtol=0, atol=AUX_ATOL)


@pytest.mark.parametrize("shape,variant", CASES)
def test_moe_apply_ep_gradients_match_reference(runs, shape, variant):
    dp, tp = shape
    key = f"{_shape_key(shape)}/{variant}"
    ranks = [r[(shape, variant)] for r in _port(runs, shape)]
    gx = np.concatenate([ranks[d * tp]["gx"] for d in range(dp)])
    assert _rel(gx, runs["ref"][f"{key}/gx"]) <= GRAD_TOL
    names = sorted(k[len(key) + 3:] for k in runs["ref"] if k.startswith(f"{key}/g/"))
    assert names == sorted(ranks[0]["grads"])
    for name in names:
        want = runs["ref"][f"{key}/g/{name}"]
        for r in ranks:  # averaged over data, summed or gathered over model: the same everywhere
            assert _rel(r["grads"][name], want) <= GRAD_TOL, (name, _rel(r["grads"][name], want))


def test_capacity_factor_half_drops_in_both_stages():
    """The cf 0.5 case is one where the EP dispatch drops (its send buffer
    holds half of a rank's assignments), so it is held to the reference's
    EP dispatch and not to ``moe_apply``."""
    cfg = W.moe_cfg("granite_cf05")
    n = B * (S // 4)  # one model rank's tokens on the (1, 4) mesh
    assert -(-int(n * cfg.top_k * cfg.capacity_factor) // 4) < n * cfg.top_k


@pytest.mark.parametrize("name", ["no_err", "err"])
def test_compressed_allreduce_matches_reference(runs, name):
    want = {k: runs["ref"][f"compressed/{name}/{k}"] for k in ("mean", "new_err", "q", "scale")}
    for i, r in enumerate(runs["comp"]):
        got = r[name]
        np.testing.assert_array_equal(got["q"], want["q"][i])
        np.testing.assert_array_equal(got["scale"], want["scale"][i])
        one_rounding = np.spacing(np.abs(got["q"].astype(np.float32) * got["scale"]))
        assert np.all(np.abs(got["new_err"] - want["new_err"][i]) <= one_rounding)
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=MEAN_RTOL, atol=0)
        np.testing.assert_array_equal(got["mean"], runs["comp"][0][name]["mean"])


@pytest.mark.parametrize("name", ["no_err", "err"])
def test_compressed_allreduce_is_the_mean_of_the_ranks_codes(runs, name):
    """The mean is the ranks' dequantized codes averaged, the codes int8."""
    total = sum(r[name]["q"].astype(np.float32) * r[name]["scale"] for r in runs["comp"])
    for r in runs["comp"]:
        assert r[name]["q"].dtype == np.int8
        np.testing.assert_allclose(r[name]["mean"], total / 4, rtol=MEAN_RTOL, atol=1e-7)


def test_moe_ffn_picks_ep_exactly_where_the_reference_does(runs, monkeypatch):
    monkeypatch.setattr(moe, "moe_apply_ep", lambda *a: ("ep", None))
    monkeypatch.setattr(moe, "moe_apply", lambda *a: ("plain", None))
    chosen = []
    for hints, e, tp, s in W.SELECT_CASES:
        cfg = W.moe_cfg("granite").with_(moe_hints=hints, n_experts=e)
        with M.set_mesh(M.Mesh(("data", "model"), (1, tp))):
            pick, _ = moe._moe_ffn(cfg, {}, torch.zeros((1, s, 8)))
        chosen.append(pick == "ep")
    np.testing.assert_array_equal(np.asarray(chosen), runs["ref"]["select"])
    assert any(chosen) and not all(chosen)


def test_no_ambient_mesh_outside_set_mesh():
    assert M.get_mesh() is None and moe._ambient_mesh() is None
    with M.set_mesh(M.Mesh(("data", "model"), (1, 2))) as m:
        assert moe._ambient_mesh() is m
        with M.set_mesh(M.Mesh(("data", "model"), (2, 1))):
            assert moe._ambient_mesh() is None  # model axis of 1: moe_apply
        assert M.get_mesh() is m
    assert M.get_mesh() is None


def test_compressed_allreduce_needs_a_mesh():
    with pytest.raises(RuntimeError, match="set_mesh"):
        comp.compressed_allreduce(torch.ones(3), None, "data")


def test_mesh_coordinates_and_groups_on_three_axes(runs):
    """A (pod 2, data 1, model 2) mesh on four ranks: rank r at r's row-major
    coordinates; the data group (pod and data together) joins the ranks of
    one model coordinate, the model group those of one (pod, data); the
    batch's data shard is the (pod, data) index; a mesh of another size
    than the group is refused."""
    for rank, r in enumerate(runs["layout"]):
        pod, model = divmod(rank, 2)
        assert r["coords"] == {"pod": pod, "data": 0, "model": model}
        assert r["data_group"] == [model, model + 2]
        assert r["model_group"] == [2 * pod, 2 * pod + 1]
        assert r["data_shard"] == (pod, 2)
        assert r["refused"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        M.make_mesh((1, 2), ("data", "model"), "cpu")
