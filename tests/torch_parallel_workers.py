"""Process groups for the port's parallel tests: ``spawn`` starts ``world``
gloo ranks on the CPU (``torch.multiprocessing``, a ``file://`` rendezvous
under the test's own directory, so parallel test workers never share a
port), runs a job of this module on each, and returns each rank's result.

Jobs import torch and the port only (no JAX), and run on one intra-op
thread each: a test run shares the machine's cores among its workers.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models import base, moe, registry
from repro_torch.parallel import collectives as C
from repro_torch.parallel import compression as comp
from repro_torch.parallel import sharding
from repro_torch.training import optim
from repro_torch.training import train_step as ts

SPAWN_TIMEOUT_S = 300
# the EP cases: mesh shapes (data, model) and MoE variants (``moe_cfg``)
MESH_SHAPES = ((1, 4), (2, 2), (1, 2))
VARIANTS = ("granite", "granite_cf05", "deepseek")
# _moe_ffn's choice: (moe_hints, n_experts, model axis size, sequence length)
SELECT_CASES = [(h, e, tp, s) for h in (False, True) for e in (8, 6) for tp in (1, 2, 4)
                for s in (16, 6)]


def _main(rank, world, job, tmp, args):
    torch.set_num_threads(1)
    M.init_distributed("cpu", init_method=f"file://{tmp / 'rendezvous'}", rank=rank,
                       world_size=world)
    try:
        out = globals()[job](*args)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp: Path, *args) -> list:
    """``job(*args)`` on each of ``world`` gloo ranks; their results in rank
    order."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_main, args=(world, job, tmp, args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    # join returns as each rank ends (False while any runs) and raises if one failed
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{job} on {world} ranks did not end within {SPAWN_TIMEOUT_S} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------
def moe_cfg(variant: str):
    """The MoE configs of the EP cases, in f32: smoke granite with
    ``moe_hints``, the same at capacity factor 0.5 (both stages drop), and
    smoke deepseek-v3 (one shared expert)."""
    arch = "deepseek-v3-671b" if variant == "deepseek" else "granite-moe-3b-a800m"
    cfg = smoke_variant(ARCHS[arch]).with_(moe_hints=True)
    return cfg.with_(capacity_factor=0.5) if variant == "granite_cf05" else cfg


def ep_case(mesh, cfg, inputs):
    """``moe_apply_ep`` on this rank: its rows of x over the data axes, whole
    over "model". The rank's loss is ``dp * <y_d, dy_d> + daux * aux``, so
    that the mean of the ranks' losses is the global ``<y, dy> + daux * aux``;
    the parameters' gradients are then averaged over the data axes, as a
    data-parallel step averages them, and x's rows' gradient is the rank's
    own over dp (the mean over data ranks, the others adding nothing)."""
    dp = mesh.shape["data"]
    d = mesh.axis_index("data")
    rows = slice(d * inputs["x"].shape[0] // dp, (d + 1) * inputs["x"].shape[0] // dp)
    p = {k[2:]: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()
         if k.startswith("p.") and "." not in k[2:]}
    shared = {k[9:]: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()
              if k.startswith("p.shared.")}
    if shared:
        p["shared"] = shared
    x = torch.from_numpy(inputs["x"][rows]).requires_grad_()
    y, aux = moe.moe_apply_ep(p, x, cfg, mesh)
    loss = dp * (y * torch.from_numpy(inputs["dy"][rows])).sum() + float(inputs["daux"]) * aux
    loss.backward()
    leaves = base.tree_leaves(p)
    grads = C.mean_over([t.grad for t in leaves], mesh.data_group)
    return dict(y=y.detach().numpy(), aux=aux.detach().numpy(), gx=(x.grad / dp).numpy(),
                grads=dict(zip(base.tree_paths(p), (g.numpy() for g in grads))))


def ep_cases(shapes, variants, inputs):
    """Every (mesh shape, variant) EP case on this rank, keyed by both."""
    out = {}
    for shape in shapes:
        mesh = M.make_mesh(shape, ("data", "model"), "cpu")
        for v in variants:
            out[(shape, v)] = ep_case(mesh, moe_cfg(v), inputs[v])
    return out


def compressed_case(inputs):
    """``compressed_allreduce`` over a 1-D "data" axis of every rank: rank
    i's own x and err, without and with the error feedback."""
    mesh = M.make_mesh((dist.get_world_size(), 1), ("data", "model"), "cpu")
    i = dist.get_rank()
    x, err = torch.from_numpy(inputs["x"][i]), torch.from_numpy(inputs["err"][i])
    out = {}
    with M.set_mesh(mesh):
        for name, e in (("no_err", None), ("err", err)):
            mean, new_err = comp.compressed_allreduce(x, e, "data")
            q, scale, _ = comp.compress(x, e)
            out[name] = dict(mean=mean.numpy(), new_err=new_err.numpy(), q=q.numpy(),
                             scale=scale.numpy())
    return out


def mesh_layout():
    """This rank's coordinates on a ("pod", "data", "model") mesh of every
    rank (2 x 1 x 2 on four), the ranks of its data group (pod and data
    together) and of its model group, its data shard as ``launch.train``
    takes it, and whether a mesh of the wrong size is refused."""
    from repro_torch.launch import train

    world = dist.get_world_size()
    mesh = M.make_mesh((2, world // 4, 2), ("pod", "data", "model"), "cpu")
    me = torch.tensor([dist.get_rank()])

    def members(group):
        parts = [torch.zeros_like(me) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, me, group=group)
        return [int(t) for t in parts]

    try:
        M.make_mesh((world + 1,), ("data",), "cpu")
        refused = False
    except ValueError:
        refused = True
    return dict(coords={ax: mesh.axis_index(ax) for ax in mesh.axis_names},
                data_group=members(mesh.data_group), model_group=members(mesh.group("model")),
                data_shard=train._data_shard(mesh), refused=refused)


def jobs(*calls):
    """Several jobs of this module in turn on one world: (name, args) each."""
    return [globals()[name](*args) for name, args in calls]


def f32_materialize():
    """``base.materialize`` with every parameter drawn in float32 (the
    tests' f32 runs of ``launch.train.run``); returns the original."""
    orig = base.materialize
    base.materialize = functools.partial(orig, dtype=torch.float32)
    return orig


def assert_run_matches(ranks, kw, params_atol=1e-5):
    """Each rank's ``train_runs`` result of the f32 run ``kw`` held against
    ``launch.train.run`` on one process (f32 parameters): the same logged
    steps, the losses within rtol 1e-5, and the gathered parameters within
    rtol 1e-5 plus ``params_atol`` (AdamW's step of an entry whose gradient
    nearly cancels takes the sums' order)."""
    from repro_torch.launch.train import run

    orig = f32_materialize()
    try:
        params, hist = run(device="cpu", **kw)
    finally:
        base.materialize = orig
    want = {k: v.numpy() for k, v in base.tree_paths(params).items()}
    for r in ranks:
        assert [s for s, _ in r["hist"]] == [s for s, _ in hist]
        np.testing.assert_allclose([l for _, l in r["hist"]], [l for _, l in hist], rtol=1e-5,
                                   atol=0)
        assert r["params"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-5, atol=params_atol,
                                       err_msg=k)


def run_cfg(kw):
    """The config ``launch.train.run`` trains for its keyword arguments."""
    if kw.get("cfg") is not None:
        return kw["cfg"]
    return smoke_variant(ARCHS[kw["arch"]]) if kw.get("smoke", True) else ARCHS[kw["arch"]]


def train_runs(jobs):
    """``launch.train.run`` on this rank, once per job: (mesh shape, run's
    keyword arguments, f32 parameters). Returns each run's hist, final
    parameters (gathered whole where the mesh split them; numpy, f32) and
    how many times it called ``moe_apply_ep`` and the step's mean over the
    data axes (``collectives.mean_over``)."""
    from repro_torch.launch import train

    where = {"ep": (moe, "moe_apply_ep"), "mean": (C, "mean_over")}
    real = {name: getattr(mod, attr) for name, (mod, attr) in where.items()}
    calls = dict.fromkeys(where, 0)

    def counting(name):
        def counted(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return counted

    for name, (mod, attr) in where.items():
        setattr(mod, attr, counting(name))
    out = []
    try:
        for shape, kw, f32 in jobs:
            mesh = M.make_mesh(shape, ("data", "model"), "cpu")
            orig = f32_materialize() if f32 else None
            calls.update(dict.fromkeys(calls, 0))
            try:
                params, hist = train.run(mesh=mesh, device="cpu", **kw)
            finally:
                if orig is not None:
                    base.materialize = orig
            params = sharding.gather_params(params, run_cfg(kw), mesh)
            out.append(dict(hist=hist, ep_calls=calls["ep"], mean_over_calls=calls["mean"],
                            params={k: v.float().numpy()
                                    for k, v in base.tree_paths(params).items()}))
    finally:
        for name, (mod, attr) in where.items():
            setattr(mod, attr, real[name])
    return out


def numpy_inputs(cfg, seed: int, b: int, s: int) -> dict:
    """f32 inputs of one EP case, drawn by numpy: the MoE parameters
    (``p.<name>``, the shared expert's ``p.shared.<name>``), x, the output's
    cotangent dy and aux's, daux."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in base.tree_paths(moe.moe_specs(cfg)).items():
        fan_in = spec.shape[-2]
        out[f"p.{path}"] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)).astype(np.float32)
    out["x"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    out["dy"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    out["daux"] = np.float32(rng.uniform(1, 3))
    return out


# --------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_tensor_parallel.py)
# --------------------------------------------------------------------------
def tp_cfg(case):
    """A tensor-parallel case's config: the smoke variant of ``arch`` with
    its overrides, in bf16 where the case says so."""
    cfg = smoke_variant(ARCHS[case["arch"]]).with_(**case["overrides"])
    return cfg.with_(dtype=torch.bfloat16) if case["dtype"] == "bfloat16" else cfg


def tp_inputs(case, seed: int, b: int, s: int) -> dict:
    """A case's parameters (drawn by numpy on the port's specs in float32,
    nothing zero or one, so that every leaf's gradient is its own;
    bf16-rounded for a bf16 case; in the reference's layout through
    ``convert``) and its batch of ``b`` rows of ``s`` tokens, whose first two
    labels of every row are ignored (-1); a VLM's ``img_embeds`` and an
    encoder-decoder's ``frames`` too."""
    cfg = tp_cfg(case)
    rng = np.random.default_rng(seed)

    def init(spec):
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        if spec.init == "ones":
            x = 1 + 0.1 * x
        elif spec.init == "scaled" and len(spec.shape) >= 2:
            x = x / np.float32(np.sqrt(spec.shape[-2]))
        else:
            x = 0.02 * x
        t = torch.from_numpy(x.astype(np.float32))
        return t.to(torch.bfloat16) if case["dtype"] == "bfloat16" else t

    params = base.tree_map(init, registry.get_api(cfg).specs())
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, :2] = -1
    out = dict(params=convert.params_to_numpy(params), labels=labels,
               tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model),
                                                dtype=np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model), dtype=np.float32)
    return out


def tp_case(case, inputs):
    """The loss and the gradients of one case on this rank, as a step on the
    case's mesh computes them: the parameters (the reference's layout,
    numpy) carried over by ``convert`` and placed by ``shard_params``, this
    rank's rows of the batch over the data axis, the loss and gradients
    averaged over it (``collectives.mean_over``, as the step does), the
    clipping norm over the mesh (``optim.global_norm``), and the gradients
    gathered whole (``convert.params_to_numpy`` of the sharded tree); the
    split leaves' paths and the rank's gradient bytes before the gather."""
    cfg = tp_cfg(case)
    api = registry.get_api(cfg)
    mesh = M.make_mesh(tuple(case["mesh"]), ("data", "model"), "cpu")
    params = convert.params_from_numpy(inputs["params"], cfg, "cpu")
    if case["dtype"] == "bfloat16":
        params = base.tree_map(lambda t: t.to(torch.bfloat16), params)
    params = sharding.shard_params(params, cfg, mesh)
    dp, d = mesh.shape["data"], mesh.axis_index("data")
    rows = slice(d * inputs["tokens"].shape[0] // dp, (d + 1) * inputs["tokens"].shape[0] // dp)
    batch = {k: torch.from_numpy(v[rows]) for k, v in inputs.items() if k != "params"}
    with M.set_mesh(mesh):
        loss, grads = ts.value_and_grad(api.loss_fn, params, batch, api.idle_params)
    loss, *leaves = C.mean_over([loss, *base.tree_leaves(grads)], mesh.data_group)
    grads = base.tree_unflatten(grads, leaves)
    split = [dim is not None for dim in sharding.split_dims(cfg, mesh)]
    gnorm = optim.global_norm(grads, split, mesh.group("model"))
    return dict(loss=float(loss), grad_norm=float(gnorm), n_split=sum(split),
                split_paths=[p for p, sp in zip(base.tree_paths(grads), split) if sp],
                grad_bytes=dryrun.tree_bytes(grads),
                grads=base.tree_paths(convert.params_to_numpy(grads, cfg, mesh)))


def step_grads(cfg, params, batch, microbatches: int, mesh=None) -> dict:
    """One ``make_train_step`` step under ``set_mesh(mesh)`` (None: one
    process): its loss, its grad norm and the gradients it hands to
    ``optim.update``, in the reference's layout (numpy, gathered whole)."""
    seen = {}
    real = optim.update

    def update(ocfg, params, grads, *a):
        seen["grads"] = grads
        return real(ocfg, params, grads, *a)

    optim.update = update
    try:
        with M.set_mesh(mesh):
            _, _, metrics = ts.make_train_step(cfg, optim.AdamWConfig(), microbatches, mesh)(
                params, optim.init(params), batch)
    finally:
        optim.update = real
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                grads=base.tree_paths(convert.params_to_numpy(seen["grads"], cfg, mesh)))


def global_batch_steps(case, inputs, microbatches):
    """``step_grads`` on this rank of a (data, 1) mesh, for each count of
    ``microbatches``: the case's parameters (``tp_inputs``) and this data
    rank's rows of its batch as ``launch.train.run`` takes them
    (``data_rows``)."""
    from repro_torch.launch.train import data_rows

    cfg = tp_cfg(case)
    mesh = M.make_mesh(tuple(case["mesh"]), ("data", "model"), "cpu")
    out = {}
    for mb in microbatches:
        params = convert.params_from_numpy(inputs["params"], cfg, "cpu")
        rows = data_rows(inputs["tokens"].shape[0], mesh.axis_index("data"),
                         mesh.shape["data"], mb)
        batch = {k: torch.from_numpy(v[rows]) for k, v in inputs.items() if k != "params"}
        out[mb] = step_grads(cfg, params, batch, mb, mesh)
    return out


def tp_cases(cases, inputs):
    """Every case of this world's size on this rank, keyed by its name."""
    world = dist.get_world_size()
    return {c["name"]: tp_case(c, inputs[c["name"]]) for c in cases
            if c["mesh"][0] * c["mesh"][1] == world}


def placement_bytes(archs, shape):
    """This rank's bytes of parameters and AdamW state as ``launch.train.run``
    places them on a mesh of ``shape``: each arch's smoke variant drawn in
    its specs' dtypes, then ``shard_params``."""
    mesh = M.make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    for arch, overrides in archs:
        cfg = smoke_variant(ARCHS[arch]).with_(**overrides)
        params = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0))
        params = sharding.shard_params(params, cfg, mesh)
        out[arch, tuple(sorted(overrides.items()))] = dict(
            params=dryrun.tree_bytes(params), opt_state=dryrun.tree_bytes(optim.init(params)))
    return out


def ckpt_across_meshes(shape, save_dir, restore_dir, arch="tinyllama-1.1b"):
    """Checkpoints across meshes, on a mesh of ``shape``: one train step of
    ``arch``'s smoke variant (its specs' dtypes) placed over the mesh, saved by
    ``CheckpointManager(cfg=, mesh=)`` into ``save_dir``; then the newest
    checkpoint of ``restore_dir`` (written without a mesh) restored into the
    placement. Both trees come back gathered whole, numpy by dotted path."""
    from repro_torch.checkpoint.manager import CheckpointManager

    cfg = smoke_variant(ARCHS[arch])
    mesh = M.make_mesh(shape, ("data", "model"), "cpu")
    params = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(0))
    params = sharding.shard_params(params, cfg, mesh)
    state = optim.init(params)
    batch = {k: torch.from_numpy(v) for k, v in ckpt_batch(cfg).items()}
    step = ts.make_train_step(cfg, optim.AdamWConfig(lr=1e-3, warmup=1), mesh=mesh)
    with M.set_mesh(mesh):
        params, state, _ = step(params, state, batch)
    mgr = CheckpointManager(save_dir, async_=False, cfg=cfg, mesh=mesh)
    mgr.save(1, (params, state))
    saved = sharding.gather_params((params, state), cfg, mesh)
    _, restored, _ = CheckpointManager(restore_dir, cfg=cfg, mesh=mesh).restore_latest(
        (params, state), device="cpu")
    restored_bytes = dryrun.tree_bytes(restored)
    restored = sharding.gather_params(restored, cfg, mesh)
    return dict(saved=host(saved), restored=host(restored), restored_bytes=restored_bytes)


def host(tree):
    """A tree as numpy by dotted path, bf16 leaves as their int16 bits."""
    return {k: v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in base.tree_paths(tree).items()}


def one_process_ckpt(ckpt_dir, arch="tinyllama-1.1b"):
    """One train step of ``arch``'s smoke variant (its specs' dtypes) on one
    process, saved into ``ckpt_dir``; the tree (params, state) as ``host``
    gives it."""
    from repro_torch.checkpoint.manager import CheckpointManager

    cfg = smoke_variant(ARCHS[arch])
    params = base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(1))
    state = optim.init(params)
    batch = {k: torch.from_numpy(v) for k, v in ckpt_batch(cfg).items()}
    params, state, _ = ts.make_train_step(cfg, optim.AdamWConfig(lr=1e-3, warmup=1))(
        params, state, batch)
    CheckpointManager(ckpt_dir, async_=False).save(1, (params, state))
    return host((params, state))


def ckpt_batch(cfg, b: int = 4, s: int = 16) -> dict:
    """The checkpoint cases' one batch, drawn by numpy."""
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}
