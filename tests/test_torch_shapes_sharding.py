"""The port's shapes, input specs, partition rules and meshes against the JAX
package's (``configs/shapes.py``, ``registry.input_specs``,
``base.{spec_partition,param_pspecs}``, ``parallel/sharding.py``), with no
compile: the reference's rules run on ``jax.sharding.AbstractMesh``es of the
same axes, so no fake devices are needed.

Every parameter leaf of all ten architectures at their published widths,
every input, and every cache leaf (with and without ``seq_shard``) must get
the same partition spec on 16x16, 2x16x16 and 1x1 meshes; tuples of axes
such as ("pod", "data") compare as tuples. The reference stacks a layer
group's leaves on a leading "layers" axis (always replicated); the port
keeps a list of per-layer leaves, each of which must carry the stacked
spec without that axis.
"""

import jax.numpy as jnp
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro.configs import shapes as j_shapes
from repro.models import base as j_base
from repro.models import registry as j_registry
from repro.parallel import sharding as j_sharding
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, applicable, shapes
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import base, registry
from repro_torch.models.base import NamedSharding, PartitionSpec
from repro_torch.parallel import sharding

MESHES = {  # name -> (the reference's abstract mesh, the port's)
    "16x16": (AbstractMesh((16, 16), ("data", "model")), port_mesh.make_production_mesh()),
    "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                port_mesh.make_production_mesh(multi_pod=True)),
    "1x1": (AbstractMesh((1, 1), ("data", "model")), port_mesh.make_host_mesh("cpu")),
}
ARCH_NAMES = list(J_ARCHS)


def flat(tree, prefix=""):
    """{dotted path: leaf} of nested dicts (a leaf: anything else)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flat(sub, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def stacked(tree):
    """The port's tree of PartitionSpecs in the reference's layout: a layer
    group's list (all its layers' specs equal) becomes one dict whose specs
    gain the stacked dim's None in front."""
    out = {}
    for k, v in tree.items():
        if k in convert.LAYER_GROUPS and isinstance(v, list):
            assert all(layer == v[0] for layer in v), f"{k}: layers differ in their specs"
            out[k] = base.tree_map(lambda p: (None, *p), v[0])
        elif isinstance(v, dict):
            out[k] = stacked(v)
        else:
            out[k] = tuple(v)
    return out


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shapes_and_applicable_equal_the_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in shapes.ALL_SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in j_shapes.ALL_SHAPES]
    assert list(SHAPES) == list(j_shapes.SHAPES)
    assert shapes.SUBQUADRATIC_FAMILIES == j_shapes.SUBQUADRATIC_FAMILIES
    for family in ("dense", "vlm", "moe", "encdec", "ssm", "hybrid"):
        for name in SHAPES:
            assert applicable(family, SHAPES[name]) == \
                j_shapes.applicable(family, j_shapes.SHAPES[name]), (family, name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch):
    """Shapes and dtypes of every input (and decode cache leaf) of every
    cell, and all on the meta device."""
    for name in SHAPES:
        got = flat(registry.input_specs(ARCHS[arch], SHAPES[name]))
        want = flat(j_registry.input_specs(J_ARCHS[arch], j_shapes.SHAPES[name]))
        assert {p: (tuple(t.shape), dtype_name(t.dtype)) for p, t in got.items()} == \
            {p: (tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in want.items()}, (arch, name)
        assert all(t.device.type == "meta" for t in got.values())


def test_abstract_is_meta_and_allocates_nothing():
    specs = registry.get_api(ARCHS["tinyllama-1.1b"]).specs()
    params = base.abstract(specs)
    leaves = base.tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert [(tuple(t.shape), t.dtype) for t in leaves] == \
        [(s.shape, s.dtype) for s in base.tree_leaves(specs)]
    assert all(t.dtype == torch.float32 for t in base.tree_leaves(base.abstract(specs,
                                                                                torch.float32)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_and_param_specs_equal_the_reference(arch, mesh_name):
    jm, pm = MESHES[mesh_name]
    rules = sharding.make_rules(ARCHS[arch], pm)
    assert rules == j_sharding.make_rules(J_ARCHS[arch], jm)
    got = stacked(base.param_pspecs(registry.get_api(ARCHS[arch]).specs(), pm, rules))
    want = j_base.param_pspecs(j_registry.get_api(J_ARCHS[arch]).specs(), jm, rules)
    assert flat(got) == {p: tuple(s) for p, s in flat(want).items()}
    # param_shardings carries the same specs
    shard = base.tree_leaves(sharding.param_shardings(ARCHS[arch],
                                                      registry.get_api(ARCHS[arch]).specs(), pm))
    assert [s.spec for s in shard] == \
        base.tree_leaves(base.param_pspecs(registry.get_api(ARCHS[arch]).specs(), pm, rules))


def _specs(tree):
    return {p: tuple(s.spec) for p, s in flat(tree).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    """Every train/prefill input, the decode tokens and positions, and every
    cache leaf with and without seq_shard, leaf by leaf. Under seq_shard the
    reference puts "model" on the sequence dim of a cache whose heads already
    take it (it looks for "model" among ``tree_leaves`` of its spec, which
    here is the spec itself), and JAX refuses that spec; the rule as stated
    leaves such a leaf as it is without seq_shard, and so does the port."""
    jm, pm = MESHES[mesh_name]
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for name in SHAPES:
        inputs = registry.input_specs(cfg, SHAPES[name])
        j_inputs = j_registry.input_specs(jcfg, j_shapes.SHAPES[name])
        assert _specs(sharding.batch_shardings(cfg, inputs, pm)) == \
            _specs(j_sharding.batch_shardings(jcfg, j_inputs, jm)), (arch, name)
        if "cache" not in inputs:
            continue
        j_cache = flat(j_inputs["cache"])
        for seq_shard in (False, True):
            got = _specs(sharding.cache_shardings(cfg, inputs["cache"], pm, seq_shard=seq_shard))
            assert got.keys() == j_cache.keys()
            for path, leaf in j_cache.items():
                try:
                    want = j_sharding.cache_shardings(jcfg, leaf, jm, seq_shard=seq_shard).spec
                except DuplicateSpecError:
                    want = j_sharding.cache_shardings(jcfg, leaf, jm).spec
                    assert seq_shard and "model" in tuple(want), (path, want)
                assert got[path] == tuple(want), (arch, name, seq_shard, path)


def test_granite_experts_fall_back_and_the_latent_cache_takes_seq_shard():
    """Granite's 40 experts do not split 16 ways, so the expert FFN width
    takes "model"; deepseek-v3's MLA latent cache has no head dim and takes
    the model axis on its sequence only under seq_shard."""
    _, pm = MESHES["16x16"]
    rules = sharding.make_rules(ARCHS["granite-moe-3b-a800m"], pm)
    assert rules["experts"] is None and rules["moe_ff"] == "model"
    cfg = ARCHS["deepseek-v3-671b"]
    cache = registry.input_specs(cfg, SHAPES["decode_32k"])["cache"]
    plain = _specs(sharding.cache_shardings(cfg, cache, pm))
    seq = _specs(sharding.cache_shardings(cfg, cache, pm, seq_shard=True))
    assert plain == {k: (None, "data", None, None) for k in cache}
    assert seq == {k: (None, "data", "model", None) for k in cache}


def test_meshes_and_placements():
    single, multi = port_mesh.make_production_mesh(), port_mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert single.device is None
    host = port_mesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and host.device == torch.device("cpu")
    # tokens of a 2x16x16 training batch: dim 0 over pod then data
    s = NamedSharding(multi, PartitionSpec(("pod", "data"), None))
    assert s.placements == (Shard(0), Shard(0), Replicate())
    assert s.shard_shape((256, 4096)) == (8, 4096)
    w = NamedSharding(single, PartitionSpec(None, "model"))
    assert w.placements == (Replicate(), Shard(1)) and w.shard_shape((2048, 5632)) == (2048, 352)
    with pytest.raises(ValueError, match="does not split"):
        w.shard_shape((2048, 100))
