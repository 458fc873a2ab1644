"""Carry the JAX package's parameters and cache state into the port.

Both functions take numpy arrays (the caller does the ``np.asarray`` on the
JAX side), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import TieredKV


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


def params_from_numpy(tree, cfg, device=None):
    """The reference's parameter tree ({"embed", "layers", "ln_f"}, with every
    ``layers`` leaf stacked on a leading (n_layers,) axis) -> the port's tree,
    whose ``layers`` is a list of per-layer dicts. Weight orientation is the
    same in both (``x @ W``), so nothing is transposed."""
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "layers"}

    def layer(sub, i):
        if isinstance(sub, dict):
            return {k: layer(v, i) for k, v in sub.items()}
        if np.shape(sub)[0] != cfg.n_layers:
            raise ValueError(f"stacked layer leaf has leading dim {np.shape(sub)[0]}, "
                             f"expected n_layers={cfg.n_layers}")
        return tensor_from_numpy(np.asarray(sub)[i], device)

    out["layers"] = [layer(tree["layers"], i) for i in range(cfg.n_layers)]
    return out


def cache_from_numpy(cache, device=None) -> dict:
    """The reference's dense KV cache ({"k", "v"} of (L, B, S, Hk, Dh), and at
    kv_bits < 16 the int8 codes with {"k_scale", "v_scale"} f32 scales) with
    numpy leaves -> the port's, every dtype kept."""
    return _tree(dict(cache), resolve_device(device))


def tieredkv_from_numpy(leaves, device=None) -> TieredKV:
    """The reference's ``TieredKV`` with numpy leaves (a NamedTuple or a dict
    of its fields; ``free`` a sequence of three masks) -> the port's."""
    device = resolve_device(device)
    fields = leaves._asdict() if hasattr(leaves, "_asdict") else dict(leaves)
    conv = {k: tensor_from_numpy(v, device) for k, v in fields.items() if k != "free"}
    conv["free"] = tuple(tensor_from_numpy(f, device) for f in fields["free"])
    return TieredKV(**conv)
