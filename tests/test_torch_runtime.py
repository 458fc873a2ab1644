"""Twins of tests/test_runtime.py against the port: the data pipeline, the
checkpoint manager (atomicity, rotation, resume), the watchdog's failover
plan, gradient compression with error feedback, AdamW, and the end-to-end
training run (``launch.train.run`` on the CPU), whose first ten losses are
held against the reference's own loop.

Tolerances: the data pipeline's batches equal the reference's exactly (the
same numpy code); ``compress`` on the same input gives the reference's codes
exactly and its scale and residual within rtol 1e-6 (one float32 division
and multiply each). The end-to-end run has bf16 parameters, as the
reference's ``materialize`` makes them, so the two loops part as their
updates round to bf16: step 0 within atol 1e-5 (measured 4.8e-7: one
forward of the same parameters), steps 1-9 within atol 5e-4 (measured
<= 5.2e-5, once bf16 roundings of the updated weights differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_variant as j_smoke_variant
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.parallel import compression as j_comp
from repro.training import optim as j_optim
from repro.training import train_step as j_ts
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.manager import CheckpointManager, WatchdogState
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import base, registry
from repro_torch.parallel import compression as comp
from repro_torch.training import optim


class TestData:
    def test_deterministic_and_resumable(self):
        d = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=8))
        b1 = d.batch_at(5)
        b2 = d.batch_at(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_host_sharding_partitions_batch(self):
        d = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=8))
        s0 = d.batch_at(3, shard=0, n_shards=2)
        s1 = d.batch_at(3, shard=1, n_shards=2)
        assert s0["tokens"].shape == (4, 16)
        assert not np.array_equal(s0["tokens"], s1["tokens"])

    def test_learnable_structure(self):
        cfg = DataConfig(vocab=100, seq_len=64, global_batch=4, noise=0.0)
        b = SyntheticLM(cfg).batch_at(0)
        pred = (b["tokens"] * cfg.mult + cfg.add) % cfg.vocab
        np.testing.assert_array_equal(pred, b["labels"])

    @pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2), (60, 3, 4)])
    def test_batches_equal_the_reference(self, step, shard, n_shards):
        kw = dict(vocab=512, seq_len=64, global_batch=8, seed=3)
        got = SyntheticLM(DataConfig(**kw)).batch_at(step, shard, n_shards)
        want = JSyntheticLM(JDataConfig(**kw)).batch_at(step, shard, n_shards)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


class TestCheckpoint:
    def _tree(self, k=0):
        return {"a": torch.arange(6.0) + k, "b": {"c": torch.ones((2, 3)) * k}}

    def test_roundtrip(self, tmp_path):
        t = self._tree(3)
        ckpt.save(tmp_path / "c1", t, step=7)
        out, manifest = ckpt.restore(tmp_path / "c1", base.tree_map(torch.zeros_like, t),
                                     device="cpu")
        assert manifest["step"] == 7
        for a, b in zip(base.tree_leaves(t), base.tree_leaves(out)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_async_save(self, tmp_path):
        t = self._tree(1)
        join = ckpt.save(tmp_path / "c2", t, step=1, async_=True)
        t["a"].add_(5)  # the save copied to the host first: a later in-place change is not saved
        join()
        out, _ = ckpt.restore(tmp_path / "c2", t, device="cpu")
        assert float(out["a"][0]) == 1.0

    def test_manager_rotation_and_resume(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, interval=10, async_=False)
        for s in (10, 20, 30):
            mgr.save(s, self._tree(s))
        assert mgr.all_steps() == [20, 30]
        step, tree, _ = mgr.restore_latest(self._tree(0), device="cpu")
        assert step == 30 and float(tree["a"][0]) == 30.0

    def test_manager_skips_corrupt(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3, interval=1, async_=False)
        mgr.save(1, self._tree(1))
        bad = mgr.dir_for(2)
        bad.mkdir()
        (bad / "manifest.json").write_text("{not json")
        assert mgr.latest() == 1

    def test_elastic_restore_dtype_and_shape_checked(self, tmp_path):
        t = self._tree(2)
        ckpt.save(tmp_path / "c3", t, step=1)
        wrong = {"a": torch.zeros((5,)), "b": {"c": torch.zeros((2, 3))}}
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path / "c3", wrong, device="cpu")

    def test_restore_casts_to_the_like_tree_and_keeps_bf16_bits(self, tmp_path):
        t = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
             .to(torch.bfloat16), "n": torch.tensor(7, dtype=torch.int32)}
        ckpt.save(tmp_path / "c4", t, step=2)
        out, manifest = ckpt.restore(tmp_path / "c4", t, device="cpu")
        assert manifest["leaves"]["w"] == {"shape": [4, 3], "dtype": "bfloat16"}
        assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], t["w"])
        as_f32, _ = ckpt.restore(tmp_path / "c4", {"w": torch.zeros(4, 3), "n": t["n"]},
                                 device="cpu")
        assert as_f32["w"].dtype == torch.float32 and torch.equal(as_f32["w"], t["w"].float())


class TestWatchdog:
    def test_failover_plan(self):
        w = WatchdogState(n_hosts=4, timeout_s=10)
        now = 100.0
        for h in range(4):
            w.heartbeat(h, now)
        assert w.plan(now + 5, dp_width=4)["restart_required"] is False
        # host 3 goes silent
        for h in range(3):
            w.heartbeat(h, now + 30)
        plan = w.plan(now + 30, dp_width=4)
        assert plan["dead"] == [3]
        assert plan["restart_required"] and plan["new_dp_width"] == 2
        assert plan["action"] == "elastic_restart_from_latest_checkpoint"


class TestCompression:
    def test_error_feedback_preserves_sum(self):
        # With EF, the cumulative applied gradient tracks the exact one.
        rng = np.random.default_rng(0)
        g_true = [torch.tensor(rng.normal(size=(64,)), dtype=torch.float32) for _ in range(50)]
        err = None
        applied = torch.zeros((64,))
        for g in g_true:
            q, s, err = comp.compress(g, err)
            applied = applied + comp.decompress(q, s)
        exact = sum(g_true)
        rel = float(torch.linalg.norm(applied - exact) / torch.linalg.norm(exact))
        assert rel < 0.02, rel  # residual bounded by one quantization step

    def test_without_ef_is_worse(self):
        rng = np.random.default_rng(0)
        g_true = [torch.tensor(rng.normal(size=(64,)) * (0.01 if i % 2 else 1.0),
                               dtype=torch.float32) for i in range(50)]
        err = None
        with_ef = torch.zeros((64,))
        no_ef = torch.zeros((64,))
        for g in g_true:
            q, s, err = comp.compress(g, err)
            with_ef += comp.decompress(q, s)
            q2, s2, _ = comp.compress(g, None)
            no_ef += comp.decompress(q2, s2)
        exact = sum(g_true)
        e_ef = float(torch.linalg.norm(with_ef - exact))
        e_no = float(torch.linalg.norm(no_ef - exact))
        assert e_ef < e_no

    def test_tree_api(self):
        g = {"w": torch.ones((4, 4)), "b": torch.full((4,), 0.5)}
        q, s, e = comp.compress_tree(g, None)
        out = comp.decompress_tree(q, s)
        np.testing.assert_allclose(out["w"].numpy(), 1.0, atol=1e-2)

    def test_compress_matches_reference(self):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((33, 7)) * 3).astype(np.float32)
        err = (rng.standard_normal((33, 7)) * 0.01).astype(np.float32)
        for e in (None, err):
            qj, sj, ej = j_comp.compress(jnp.asarray(x), None if e is None else jnp.asarray(e))
            qt, st, et = comp.compress(torch.from_numpy(x), None if e is None
                                       else torch.from_numpy(e))
            assert qt.dtype == torch.int8 and st.shape == ()
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
            np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6, atol=1e-6 * float(sj))


class TestOptim:
    def test_adamw_descends_quadratic(self):
        p = {"x": torch.tensor([5.0, -3.0])}
        st = optim.init(p)
        cfg = optim.AdamWConfig(lr=0.1, warmup=1, total_steps=200, weight_decay=0.0)
        for _ in range(150):
            g = {"x": 2 * p["x"]}
            p, st, _ = optim.update(cfg, p, g, st)
        assert float(p["x"].abs().max()) < 0.2

    def test_clip_norm(self):
        p = {"x": torch.zeros(3)}
        st = optim.init(p)
        cfg = optim.AdamWConfig(lr=1e-3, clip_norm=1.0)
        _, _, m = optim.update(cfg, p, {"x": torch.full((3,), 100.0)}, st)
        assert float(m["grad_norm"]) > 1.0  # reported pre-clip


def reference_losses(steps, batch, seq, lr):
    """The reference's training loop without its mesh (``jax.jit`` of its
    ``make_train_step``, as ``launch/train.py`` builds it), started from the
    parameters the port's ``run`` draws on the CPU."""
    cfg = j_smoke_variant(J_ARCHS["tinyllama-1.1b"])
    tcfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    pt = base.materialize(registry.get_api(tcfg).specs(), torch.Generator().manual_seed(0),
                          device="cpu")
    dtypes = base.tree_map(lambda t: t.dtype, convert.stack_layers(pt))
    assert all(d == torch.bfloat16 for d in base.tree_leaves(dtypes))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    convert.params_to_numpy(pt))
    ocfg = j_optim.AdamWConfig(lr=lr, warmup=20, total_steps=steps)
    state = j_optim.init(params)
    step_fn = jax.jit(j_ts.make_train_step(cfg, ocfg))
    data = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    out = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        params, state, metrics = step_fn(params, state, b)
        out.append(float(metrics["loss"]))
    return out


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's runs: the smoke model's ops are
    small, and a parallel test run shares the machine's cores among its
    workers, where more threads a worker make each step many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_end_to_end_training_loss_decreases(tmp_path, one_thread):
    from repro_torch.launch.train import run

    _, hist = run("tinyllama-1.1b", smoke=True, steps=60, batch=8, seq=64,
                  ckpt_dir=str(tmp_path / "ck"), ckpt_interval=25, lr=2e-3,
                  log_every=10, device="cpu")
    first, last = hist[0][1], hist[-1][1]
    assert last < first - 0.5, (first, last)
    # resume works
    _, hist2 = run("tinyllama-1.1b", smoke=True, steps=70, batch=8, seq=64,
                   ckpt_dir=str(tmp_path / "ck"), ckpt_interval=25, lr=2e-3,
                   log_every=10, device="cpu")
    assert hist2[0][0] >= 60  # picked up from the checkpoint

    # the first ten steps against the reference's loop from the same parameters
    # (the learning rate of steps below warmup does not depend on the run's length)
    _, first10 = run("tinyllama-1.1b", smoke=True, steps=10, batch=8, seq=64, lr=2e-3,
                     log_every=1, device="cpu")
    assert first10[0] == hist[0]
    want = reference_losses(10, 8, 64, 2e-3)
    got = [loss for _, loss in first10]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=5e-4)


def test_entry_points_need_a_device_choice(monkeypatch, tmp_path):
    """With no card and no ``device``, the training entry points raise, as do
    the fault parameters of the simulator: nothing runs on the CPU unasked."""
    from repro_torch.core import faults
    from repro_torch.launch.train import run
    from repro_torch.ssdsim import geometry

    t = {"a": torch.arange(3.0)}
    ckpt.save(tmp_path / "c", t, step=1)
    mgr = CheckpointManager(tmp_path / "m", async_=False)
    mgr.save(1, t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run("tinyllama-1.1b", steps=1, batch=2, seq=8),
                 lambda: ckpt.restore(tmp_path / "c", t),
                 lambda: mgr.restore_latest(t),
                 lambda: faults.params_for(geometry.tiny_config(prog_fail_rate=0.01))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------- data-parallel training -------------------------
TINY_RUN = dict(arch="tinyllama-1.1b", smoke=True, batch=4, seq=32, lr=2e-3, log_every=1)
GRANITE_RUN = dict(arch="granite-moe-3b-a800m", batch=2, seq=32, steps=3, log_every=1,
                   cfg=smoke_variant(ARCHS["granite-moe-3b-a800m"]).with_(
                       moe_hints=True, capacity_factor=4.0))  # E / K: nothing drops


class TestRunOnAMesh:
    """``launch.train.run(mesh=)`` on two gloo ranks spawned on the CPU
    (``tests/torch_parallel_workers.py``) against one process.

    Tolerances, f32 parameters: a mean of two shards' gradients equals the
    whole batch's only up to float32 rounding, and the model ranks' expert
    products and cross-rank sums run in another order than one process's.
    Losses rtol 1e-5 (measured <= 1.6e-7). Parameters rtol 1e-5 plus atol
    1e-5 (measured <= 4.3e-7 absolute): AdamW divides each entry by its own
    root mean square plus eps, so an entry whose gradient nearly cancels
    takes a step the two runs disagree on by a larger share
    (``tests/test_torch_train.py``), up to 1.4e-2 of a parameter near zero.
    """

    @pytest.fixture(scope="class")
    def ranks(self, tmp_path_factory):
        import torch_parallel_workers as W

        tmp = tmp_path_factory.mktemp("run_on_a_mesh")
        ck = str(tmp / "ck")
        jobs = [((2, 1), dict(TINY_RUN, steps=10), True),
                ((1, 2), GRANITE_RUN, True),
                ((2, 1), dict(TINY_RUN, steps=6), False),
                ((2, 1), dict(TINY_RUN, steps=3, ckpt_dir=ck), False),
                ((2, 1), dict(TINY_RUN, steps=6, ckpt_dir=ck), False)]
        return W.spawn("train_runs", 2, tmp / "spawn", jobs)

    @staticmethod
    def one_process(kw):
        """``run`` in this process, f32 parameters: (hist, {path: numpy})."""
        import torch_parallel_workers as W
        from repro_torch.launch.train import run

        orig = W.f32_materialize()
        try:
            params, hist = run(device="cpu", **kw)
        finally:
            base.materialize = orig
        return hist, {k: v.numpy() for k, v in base.tree_paths(params).items()}

    def _hold(self, ranks, job, kw):
        hist, params = self.one_process(kw)
        for r in ranks:
            got = r[job]
            assert [s for s, _ in got["hist"]] == [s for s, _ in hist]
            np.testing.assert_allclose([l for _, l in got["hist"]], [l for _, l in hist],
                                       rtol=1e-5, atol=0)
            assert got["params"].keys() == params.keys()
            for k, v in params.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(ranks[0][job]["hist"], ranks[1][job]["hist"])

    def test_two_data_ranks_match_one_process(self, ranks, one_thread):
        self._hold(ranks, 0, dict(TINY_RUN, steps=10))
        assert ranks[0][0]["ep_calls"] == 0

    def test_two_model_ranks_run_expert_parallel_and_match_one_process(self, ranks, one_thread):
        self._hold(ranks, 1, GRANITE_RUN)
        n_moe = GRANITE_RUN["cfg"].n_layers - GRANITE_RUN["cfg"].first_k_dense
        assert all(r[1]["ep_calls"] == n_moe * GRANITE_RUN["steps"] for r in ranks)

    def test_resume_from_a_final_save_is_bit_equal(self, ranks):
        straight, first, second = (ranks[0][j] for j in (2, 3, 4))
        assert second["hist"][0][0] == 3
        assert first["hist"] + second["hist"] == straight["hist"]
        for k, v in straight["params"].items():
            np.testing.assert_array_equal(second["params"][k], v, err_msg=k)
        for k, v in ranks[1][4]["params"].items():  # both ranks restored the same step
            np.testing.assert_array_equal(v, second["params"][k], err_msg=k)


def test_no_mesh_and_no_group_is_the_one_device_loop(one_thread):
    """``run(mesh=None)`` outside a process group is the loop it was before
    meshes: the same parameters, batches and steps, bit for bit."""
    from repro_torch.launch.train import run
    from repro_torch.training import train_step as ts

    assert not torch.distributed.is_initialized()
    params, hist = run(device="cpu", **dict(TINY_RUN, steps=4))
    cfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    want = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0),
                            device="cpu")
    ocfg = optim.AdamWConfig(lr=TINY_RUN["lr"], warmup=20, total_steps=4)
    state = optim.init(want)
    step_fn = ts.make_train_step(cfg, ocfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TINY_RUN["seq"],
                                  global_batch=TINY_RUN["batch"]))
    losses = []
    for step in range(4):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        want, state, metrics = step_fn(want, state, b)
        losses.append(float(metrics["loss"]))
    assert [l for _, l in hist] == losses
    for a, b in zip(base.tree_leaves(params), base.tree_leaves(want)):
        assert torch.equal(a, b)
