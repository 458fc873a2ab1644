"""Seeded parameters, made on the device in a few large draws.

The parameters of a configuration are laid out in one flat buffer per dtype
(each leaf aligned to 128 elements), in the order of ``param_leaves``. The
buffer is drawn in chunks of ``CHUNK`` standard normals, each from its own
generator seeded by (seed, dtype, chunk), then each leaf's part is scaled
(or set to ones) and the chunk is rounded to the buffer's dtype. So a seed
gives the same parameters wherever they are made on one kind of device, and
any chunk of the initial values can be drawn again alone: that is how the
change of a leaf over training steps is measured without a second copy.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 27
ALIGN = 128
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def layout(leaves) -> dict:
    """{dtype name: (total elements, [(name, offset, numel, shape, init), ...])}."""
    groups: dict = {}
    for name, shape, init, dt in leaves:
        total, items = groups.setdefault(dt, [0, []])
        n = math.prod(shape)
        items.append((name, total, n, tuple(shape), init))
        groups[dt][0] = total + -(-n // ALIGN) * ALIGN
    return {dt: (total, items) for dt, (total, items) in groups.items()}


def _scale(shape, init) -> float:
    if init == "normal":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])  # "scaled": by the fan-in


def _seed(seed: int, group: int, chunk: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + group * 0x100000001B3 + chunk) % (1 << 63)


def chunks(lay: dict, seed: int, device):
    """Yield (dtype name, start, values in that dtype) of each chunk of the
    initial flat buffers."""
    for g, (dt, (total, items)) in enumerate(sorted(lay.items())):
        for c, start in enumerate(range(0, total, CHUNK)):
            n = min(CHUNK, total - start)
            gen = torch.Generator(device=device).manual_seed(_seed(seed, g, c))
            x = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
            for _, off, numel, shape, init in items:
                a, b = max(off, start), min(off + numel, start + n)
                if a >= b:
                    continue
                if init == "ones":
                    x[a - start:b - start].fill_(1.0)
                else:
                    x[a - start:b - start].mul_(_scale(shape, init))
            yield dt, start, x.to(dtype_of(dt))


def make(leaves, seed: int, device) -> dict:
    """{name: tensor}: views into one flat buffer per dtype, drawn from ``seed``."""
    lay = layout(leaves)
    flats = {dt: torch.empty(total, dtype=dtype_of(dt), device=device)
             for dt, (total, _) in lay.items()}
    for dt, start, x in chunks(lay, seed, device):
        flats[dt][start:start + x.numel()].copy_(x)
    return {name: flats[dt][off:off + numel].view(shape)
            for dt, (_, items) in lay.items() for name, off, numel, shape, _ in items}


def change_norms(leaves, seed: int, device, current: dict) -> torch.Tensor:
    """Per leaf, in ``leaves`` order, the L2 norm of ``current[name]`` minus
    its initial value (drawn again chunk by chunk), in f32."""
    lay = layout(leaves)
    index = {name: i for i, (name, *_rest) in enumerate(leaves)}
    sq = torch.zeros(len(leaves), dtype=torch.float32, device=device)
    for dt, start, x in chunks(lay, seed, device):
        for name, off, numel, _, _ in lay[dt][1]:
            a, b = max(off, start), min(off + numel, start + x.numel())
            if a >= b:
                continue
            cur = current[name].reshape(-1)[a - off:b - off].float()
            d = cur - x[a - start:b - start].float()
            sq[index[name]] += torch.sum(d * d)
    return torch.sqrt(sq)
