"""Read-retry model — Equations (2)/(3) of the paper.

Counterpart of ``repro.core.retry``:

``n_RETRY >= log_{1-delta}( E_LDPC / (a * RBER * n_SENSE) )``        (3)
"""

from __future__ import annotations

import torch

from repro_torch.core import modes, rber as rber_mod

DELTA = 0.2
E_LDPC_BITS = 72.0
CODEWORD_BITS = 8192.0  # 1 KiB codeword
E_LDPC_RATE = E_LDPC_BITS / CODEWORD_BITS
ALPHA_ADJ = 1.0  # Eq.(2) adjacent-voltage-state factor `a`


def expected_retries(rber, n_sense, *, delta: float = DELTA, e_ldpc: float = E_LDPC_RATE,
                     a: float = ALPHA_ADJ):
    """Continuous Eq.-(3) retry estimate (>= 0, unclipped), in float32.

    ``log(1 - delta)`` is taken in float32 on a float32 scalar, as the
    reference takes it, not in Python double precision.
    """
    rber = rber.float()
    n_sense = n_sense.float()
    log_keep = torch.log(torch.full((), 1.0 - delta, dtype=torch.float32, device=rber.device))
    denom = torch.clamp(a * rber * n_sense, min=1e-30)
    # full_like(...) / denom is a true division; `e_ldpc / denom` would be
    # computed by torch as reciprocal(denom) * e_ldpc, one more rounding.
    raw = torch.log(torch.full_like(denom, e_ldpc) / denom) / log_keep
    return torch.clamp(raw, min=0.0)


def retry_count(mode, rber, **kw):
    """Integer retries: ceil of Eq. (3), clipped to the mode's retry table."""
    mode = mode.long()
    n_sense = modes.table(modes.N_SENSE, rber.device)[mode]
    n = torch.ceil(expected_retries(rber, n_sense, **kw)).to(torch.int32)
    hi = modes.table(modes.MAX_RETRIES, rber.device)[mode]
    return torch.minimum(torch.clamp(n, min=0), hi)


def page_retries(mode, cycles, time_h, reads, page_ids):
    """Full pipeline: Eq.(1) per-page RBER -> Eq.(3) retry count."""
    r = rber_mod.page_rber(mode, cycles, time_h, reads, page_ids)
    return retry_count(mode, r)


def read_latency_us(mode, n_retries):
    """Service time of a page read: base sense + one extra sense per retry
    (Fig. 4: for QLC, 1 retry doubles the latency, 10 retries make it 11x)."""
    base = modes.table(modes.READ_LATENCY_US, mode.device)[mode.long()]
    return base * (1.0 + n_retries.float())
