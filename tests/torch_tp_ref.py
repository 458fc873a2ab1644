"""The JAX reference's tensor-parallel training loss on fake CPU devices, for
tests/test_torch_tensor_parallel.py and
tests/test_torch_tensor_parallel_families.py. Run as a script, in a process
of its own: ``XLA_FLAGS`` must give JAX four host devices before JAX starts.

  python tests/torch_tp_ref.py IN.npz OUT.npz

IN holds ``cases`` (JSON: each case's ``name``, ``arch``, config
``overrides``, ``mesh`` (data, model) and ``dtype``) and, under
``<name>/``, its parameters in the reference's layout (``p/<dotted path>``,
f32 numpy) and its batch (``tokens``, ``labels``, the VLM's ``img_embeds``
and the encoder-decoder's ``frames``). For each case the parameters are
placed as the reference's ``launch/train.py`` places them
(``jax.device_put`` of ``sharding.param_shardings`` on a mesh of that
shape) and the batch over the data axis, and
``jax.jit(jax.value_and_grad(loss_fn))`` runs under ``jax.set_mesh`` (where
``moe._moe_ffn`` reads the mesh). OUT holds each case's ``loss``,
``grad_norm`` (``optim.global_norm`` of the gradients) and gradients
``g/<dotted path>`` (f32).
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, smoke_variant  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro.training import optim  # noqa: E402


def nest(flat: dict) -> dict:
    """{dotted path: leaf} -> nested dicts (the reference's trees are dicts
    throughout: its layer groups are stacked)."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): tree}


def case(c, inp, out):
    name = c["name"]
    dtype = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    cfg = smoke_variant(ARCHS[c["arch"]]).with_(**c["overrides"])
    if c["dtype"] == "bfloat16":
        cfg = cfg.with_(dtype=jnp.bfloat16)
    api = registry.get_api(cfg)
    shape = tuple(c["mesh"])
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    pre = f"{name}/p/"
    params = nest({k[len(pre):]: jnp.asarray(v, dtype) for k, v in inp.items()
                   if k.startswith(pre)})
    params = jax.device_put(params, sharding.param_shardings(cfg, api.specs(), mesh))
    batch = {k: jnp.asarray(inp[f"{name}/{k}"])
             for k in ("tokens", "labels", "img_embeds", "frames") if f"{name}/{k}" in inp}
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(api.loss_fn))(params, batch)
    out[f"{name}/loss"] = np.float32(loss)
    out[f"{name}/grad_norm"] = np.float32(optim.global_norm(grads))
    for path, g in paths(grads).items():
        out[f"{name}/g/{path}"] = np.asarray(g, np.float32)


def main(src, dst):
    inp = dict(np.load(src))
    out = {}
    for c in json.loads(str(inp["cases"])):
        case(c, inp, out)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
