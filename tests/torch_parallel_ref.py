"""The JAX reference's parallel layer on fake CPU devices, for
tests/test_torch_parallel.py. Run as a script, in a process of its own:
``XLA_FLAGS`` must give JAX four host devices before JAX starts.

  python tests/torch_parallel_ref.py IN.npz OUT.npz

IN holds the cases (``mesh_shapes``, ``variants``, ``select_cases``; see
``torch_parallel_workers``), each EP variant's f32 inputs under
``<variant>/<key>`` (the keys of ``torch_parallel_workers.numpy_inputs``) and
the compressed all-reduce's ``compressed/x`` and ``compressed/err`` (one row
per device). OUT holds, for each mesh shape and variant, ``moe_apply_ep``'s
``y``, ``aux`` and the gradients of ``sum(y * dy) + daux * aux`` (``gx``,
``g/<param path>``), the compressed all-reduce's outputs with each device's
codes and scale, and ``_moe_ffn``'s choice in each selection case (1 for the
EP dispatch).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, smoke_variant  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.parallel import compression  # noqa: E402


def moe_cfg(variant):
    arch = "deepseek-v3-671b" if variant == "deepseek" else "granite-moe-3b-a800m"
    cfg = smoke_variant(ARCHS[arch]).with_(moe_hints=True)
    return cfg.with_(capacity_factor=0.5) if variant == "granite_cf05" else cfg


def mesh_of(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def params_of(inp, variant):
    pre = f"{variant}/p."
    p = {k[len(pre):]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith(pre) and "." not in k[len(pre):]}
    shared = {k[len(pre) + 7:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(pre + "shared.")}
    if shared:
        p["shared"] = shared
    return p


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): tree}


def ep(inp, out):
    for shape in inp["mesh_shapes"]:
        mesh = mesh_of(tuple(int(a) for a in shape))
        for v in inp["variants"]:
            cfg = moe_cfg(v)
            p, x = params_of(inp, v), jnp.asarray(inp[f"{v}/x"])
            dy, daux = jnp.asarray(inp[f"{v}/dy"]), float(inp[f"{v}/daux"])

            def loss(p, x):
                y, aux = moe.moe_apply_ep(p, x, cfg, mesh)
                return jnp.sum(y * dy) + daux * aux, (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(
                jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
            key = f"{shape[0]}x{shape[1]}/{v}"
            out[f"{key}/y"], out[f"{key}/aux"], out[f"{key}/gx"] = y, aux, gx
            for path, g in paths(gp).items():
                out[f"{key}/g/{path}"] = g


def compressed(inp, out):
    mesh = mesh_of((4,), ("data",))
    x, err = jnp.asarray(inp["compressed/x"]), jnp.asarray(inp["compressed/err"])
    for name, with_err in (("no_err", False), ("err", True)):
        def local(x, e):
            e = e[0] if with_err else None
            mean, new_err = compression.compressed_allreduce(x[0], e, "data")
            q, scale, _ = compression.compress(x[0], e)
            return mean, new_err[None], q[None], scale[None]

        # the mean is a sum over gathered rows, which the replication check
        # cannot see is replicated: the check is off, nothing else changes
        res = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                                    out_specs=(P(), P("data"), P("data"), P("data")),
                                    check_vma=False))(x, err)
        for key, v in zip(("mean", "new_err", "q", "scale"), res):
            out[f"compressed/{name}/{key}"] = v


def select(inp, out):
    chosen = []
    real_ep, real_plain = moe.moe_apply_ep, moe.moe_apply
    moe.moe_apply_ep = lambda *a: ("ep", None)
    moe.moe_apply = lambda *a: ("plain", None)
    try:
        for hints, e, tp, s in inp["select_cases"].tolist():
            cfg = moe_cfg("granite").with_(moe_hints=bool(hints), n_experts=e)
            with jax.set_mesh(mesh_of((1, tp))):
                pick, _ = moe._moe_ffn(cfg, {}, jnp.zeros((1, s, 8)))
            chosen.append(pick == "ep")
    finally:
        moe.moe_apply_ep, moe.moe_apply = real_ep, real_plain
    out["select"] = np.asarray(chosen)


def main(src, dst):
    inp = dict(np.load(src))
    out = {}
    ep(inp, out)
    compressed(inp, out)
    select(inp, out)
    np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(*sys.argv[1:3])
