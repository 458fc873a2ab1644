"""Carry state between the JAX package and the port.

The ``*_from_numpy`` functions take numpy arrays (the caller does the
``np.asarray`` on the JAX side) and the ``*_to_numpy`` functions give them,
so this module needs no JAX. The two packages lay out a model's layers
differently: the reference stacks every leaf of a layer group (``layers``;
for MoE ``moe_layers`` and ``dense_layers``; for whisper ``enc_layers`` and
``dec_layers``; for zamba2 ``mamba_layers``) on a leading axis, the port
keeps a list of per-layer dicts; ``stack_layers`` and ``unstack_layers``
turn one into the other. Everything else (MoE's ``mtp`` block and zamba2's
``shared`` block among it) is carried as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import TieredKV
from repro_torch.models import base
from repro_torch.parallel import sharding
from repro_torch.training.optim import OptState


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 arrays included, which numpy knows only as the
    ml_dtypes extension type) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def layer_depths(cfg) -> dict:
    """The number of layers in each stacked group of ``cfg``'s parameter tree."""
    return {"layers": cfg.n_layers, "moe_layers": cfg.n_layers - cfg.first_k_dense,
            "dense_layers": cfg.first_k_dense, "enc_layers": cfg.n_enc_layers,
            "dec_layers": cfg.n_layers, "mamba_layers": cfg.n_layers}


def params_from_numpy(tree, cfg, device=None):
    """The reference's parameter tree ({"embed", "layers", "ln_f"}, or the
    other layer groups of LAYER_GROUPS and the unstacked "mtp" and "shared";
    every leaf of a layer group stacked on a leading axis) -> the port's
    tree, in which each layer group
    is a list of per-layer dicts (views of one stacked tensor per leaf).
    Weight orientation is the same in both (``x @ W``), so nothing is
    transposed."""
    return unstack_layers(_tree(dict(tree), resolve_device(device)), layer_depths(cfg))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host. bfloat16 comes back as float32
    holding the same values (numpy has no bfloat16 of its own); casting it
    to the reference's bfloat16 is exact."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


LAYER_GROUPS = ("layers", "moe_layers", "dense_layers", "enc_layers", "dec_layers",
                "mamba_layers")


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def _unstack(sub, n):
    if isinstance(sub, dict):
        return [dict(zip(sub, vals)) for vals in zip(*(_unstack(v, n) for v in sub.values()))]
    if sub.shape[0] != n:
        raise ValueError(f"stacked layer leaf has leading dim {sub.shape[0]}, expected {n}")
    return list(sub.unbind(0))


def stack_layers(tree):
    """The port's layout -> the reference's: in every dict of ``tree`` (a
    parameter tree, an ``OptState``, or tuples of them), a layer group's list
    of per-layer dicts (a key of LAYER_GROUPS) becomes one dict of tensors
    stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _stack(v) if k in LAYER_GROUPS and isinstance(v, list) else stack_layers(v)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = (stack_layers(v) for v in tree)
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def unstack_layers(tree, depths):
    """The inverse of ``stack_layers``: each stacked layer group becomes a
    list of per-layer dicts (views of the stacked tensors). ``depths`` gives
    each group's layer count (``layer_depths(cfg)``)."""
    if isinstance(tree, dict):
        return {k: _unstack(v, depths[k]) if k in LAYER_GROUPS and isinstance(v, dict)
                else unstack_layers(v, depths) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = (unstack_layers(v, depths) for v in tree)
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def params_to_numpy(params, cfg=None, mesh=None) -> dict:
    """The inverse of ``params_from_numpy``: the port's parameter tree as the
    reference's, every leaf of a layer group stacked on a leading axis, with
    numpy leaves (bfloat16 as float32, see ``tensor_to_numpy``). With
    ``mesh`` and ``cfg``, ``params`` are this rank's blocks of a run placed
    over the mesh: they are gathered whole first (``sharding.gather_params``,
    a collective every rank of the mesh calls)."""
    if mesh is not None:
        params = sharding.gather_params(params, cfg, mesh)
    return base.tree_map(tensor_to_numpy, stack_layers(params))


def opt_state_to_numpy(state: OptState, cfg=None, mesh=None) -> OptState:
    """The port's AdamW state in the reference's layout with numpy leaves;
    ``repro.training.optim.OptState(*out)`` takes its fields in order.
    ``cfg`` and ``mesh`` as ``params_to_numpy`` takes them."""
    return OptState(params_to_numpy(state.m, cfg, mesh), params_to_numpy(state.v, cfg, mesh),
                    tensor_to_numpy(state.count))


def opt_state_from_numpy(state, cfg, device=None) -> OptState:
    """The reference's AdamW state (its ``OptState`` or an (m, v, count)
    tuple) with numpy leaves -> the port's, on ``device``."""
    m, v, count = state
    return OptState(params_from_numpy(m, cfg, device), params_from_numpy(v, cfg, device),
                    tensor_from_numpy(np.asarray(count, np.int32), resolve_device(device)))


def cache_from_numpy(cache, device=None) -> dict:
    """The reference's KV cache with numpy leaves -> the port's, every key and
    dtype kept: the dense family's {"k", "v"} of (L, B, S, Hk, Dh), and at
    kv_bits < 16 the int8 codes with {"k_scale", "v_scale"} f32 scales; MoE's
    {"moe_k", "moe_v"} and, with dense-first layers, {"dense_k", "dense_v"};
    whisper's {"k", "v", "xk", "xv"}; the recurrent families' nested states
    (xlstm's {"mlstm": {...}, "slstm": {...}}, zamba2's {"mamba": {...},
    "k", "v"}). The port keeps the reference's stacked layout for caches."""
    return _tree(dict(cache), resolve_device(device))


def tieredkv_from_numpy(leaves, device=None) -> TieredKV:
    """The reference's ``TieredKV`` with numpy leaves (a NamedTuple or a dict
    of its fields; ``free`` a sequence of three masks) -> the port's."""
    device = resolve_device(device)
    fields = leaves._asdict() if hasattr(leaves, "_asdict") else dict(leaves)
    conv = {k: tensor_from_numpy(v, device) for k, v in fields.items() if k != "free"}
    conv["free"] = tuple(tensor_from_numpy(f, device) for f in fields["free"])
    return TieredKV(**conv)


def ssd_state_from_numpy(leaves, device=None):
    """The simulator state (``repro_torch.ssdsim.state.SSDState``) from the
    reference's ``SSDState`` with numpy leaves (a NamedTuple, a dict of its
    fields, or a sequence in field order), every dtype kept, on ``device``
    (CUDA unless the caller names one)."""
    from repro_torch.ssdsim.state import SSDState

    device = resolve_device(device)
    if hasattr(leaves, "_asdict"):
        leaves = leaves._asdict()
    if isinstance(leaves, dict):
        return SSDState(**{k: tensor_from_numpy(v, device) for k, v in leaves.items()})
    return SSDState(*[tensor_from_numpy(v, device) for v in leaves])


def ssd_state_to_numpy(state):
    """The port's simulator state with numpy leaves (one copy to the host per
    leaf), in field order, for the reference's ``SSDState(*leaves)``."""
    return type(state)(*[x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in state])
