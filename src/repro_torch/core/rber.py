"""Raw-bit-error-rate model — Equation (1) of the paper.

Counterpart of ``repro.core.rber``:

``RBER(cycles, time, reads) = eps + alpha*cycles^k            (wear)
                             + beta*cycles^m * time^n          (retention)
                             + gamma*cycles^p * reads^q        (read disturb)``

with a deterministic per-page lognormal variation keyed on the page id.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import modes


class RBERParams(NamedTuple):
    """Eq. (1) constants for one flash mode."""

    eps: float
    alpha: float
    k: float
    beta: float
    m: float
    n: float
    gamma: float
    p: float
    q: float


MODE_RBER_PARAMS: dict[int, RBERParams] = {
    modes.SLC: RBERParams(eps=1e-5, alpha=2e-9, k=1.0, beta=1e-11, m=1.0, n=0.5,
                          gamma=1e-12, p=1.0, q=0.5),
    modes.TLC: RBERParams(eps=6e-4, alpha=7e-7, k=1.0, beta=3.0e-10, m=1.6, n=0.7,
                          gamma=4.3e-10, p=1.0, q=1.1),
    modes.QLC: RBERParams(eps=1.3e-3, alpha=3.2e-6, k=1.0, beta=3.25e-9, m=1.6, n=0.7,
                          gamma=3.0e-9, p=1.0, q=1.1),
}

# Per-page lognormal variation of ln-RBER (DESIGN.md §6).
PAGE_SIGMA = 0.40

_U32 = 0xFFFFFFFF


def rber(mode, cycles, time_h, reads):
    """Eq. (1). All args broadcastable tensors; ``mode`` int in {0,1,2}."""
    table = modes.table(tuple(MODE_RBER_PARAMS[m] for m in range(modes.N_MODES)),
                        mode.device, torch.float32)  # (3, 9)
    P = table[mode.long()]
    eps, alpha, k, beta, m, n, gamma, p, q = P.unbind(-1)
    c = torch.clamp(cycles.float(), min=0.0)
    t = torch.clamp(time_h.float(), min=0.0)
    r = torch.clamp(reads.float(), min=0.0)
    wear = alpha * torch.pow(c, k)
    retention = beta * torch.pow(c, m) * torch.pow(t, n)
    disturb = gamma * torch.pow(c, p) * torch.pow(r, q)
    return eps + wear + retention + disturb


def _hash_u32(page_ids):
    """The reference's xorshift-style uint32 hash, computed in int64.

    Shifts on uint32 tensors are not implemented on every backend, so each
    multiply and shift is masked back to 32 bits; the low 32 bits of an
    int64 product are right even when the product wraps.
    """
    h = page_ids.to(torch.int64) & _U32
    h = (h * 0x9E3779B9) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def page_variation(page_ids, sigma: float = PAGE_SIGMA):
    """Deterministic per-page lognormal factor (process variation)."""
    h = _hash_u32(page_ids)
    u1 = ((h & 0xFFFF).float() + 0.5) / 65536.0
    u2 = (((h >> 16) & 0xFFFF).float() + 0.5) / 65536.0
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return torch.exp(sigma * z)


def page_rber(mode, cycles, time_h, reads, page_ids):
    """Eq. (1) with per-page process variation applied multiplicatively."""
    return rber(mode, cycles, time_h, reads) * page_variation(page_ids)
