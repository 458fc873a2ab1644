"""Flash-mode / KV-tier constants shared by both layers of the framework.

Counterpart of ``repro.core.modes``. Tables are plain tuples: a caller that
needs one as a tensor gets it on its own device from ``table(..., device)``,
which makes each table once per device and dtype: copying host values to a
card makes the host wait for the card, and the serve loop must not.
"""

from __future__ import annotations

import functools

import torch

# Mode ids. Order matters: lower id == lower density == higher reliability.
SLC = 0
TLC = 1
QLC = 2
N_MODES = 3

MODE_NAMES = ("SLC", "TLC", "QLC")

BITS_PER_CELL = (1, 3, 4)
# Reference-voltage senses for a worst-case page read (paper §II-D).
N_SENSE = (1, 4, 8)
# Device retry-table limits.
MAX_RETRIES = (8, 16, 16)
# Pages per block when a physical block is programmed in each mode (Table III).
PAGES_PER_BLOCK = (256, 768, 1024)
# Table IV latencies, microseconds.
READ_LATENCY_US = (20.0, 66.0, 140.0)
WRITE_LATENCY_US = (160.0, 730.0, 3102.0)
ERASE_LATENCY_US = (2000.0, 3000.0, 10000.0)
# Rated P/E endurance per mode (Table IV).
RATED_PE = (100_000, 3_000, 1_000)

# Heat classes (paper §IV-A heat classifier).
COLD = 0
WARM = 1
HOT = 2
HEAT_NAMES = ("COLD", "WARM", "HOT")

# Wear stages (Table I) — QLC P/E-cycle bands.
STAGE_YOUNG = 0
STAGE_MIDDLE = 1
STAGE_OLD = 2
STAGE_NAMES = ("young", "middle", "old")
STAGE_BOUNDS = (333, 666, 1_000_000)

# Layer-B tier view of the same ids (bf16 / int8 / int4).
TIER_BF16 = SLC
TIER_INT8 = TLC
TIER_INT4 = QLC
TIER_NAMES = ("bf16", "int8", "int4")
TIER_BITS = (16, 8, 4)


def table(values, device, dtype=None) -> torch.Tensor:
    """One of the tables above (a tuple, or a tuple of tuples) as a tensor on
    ``device`` (int32 for ints, float32 for floats, as in the reference),
    made at the first call and shared after it: callers only read it."""
    if dtype is None:
        dtype = torch.float32 if isinstance(values[0], float) else torch.int32
    return _table(values, dtype, torch.device(device))


@functools.cache
def _table(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)
