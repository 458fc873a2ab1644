"""Deterministic fault-injection model (DESIGN.md §2D).

Counterpart of ``repro.core.faults``: uncorrectable reads (past the retry
budget, or a wear-scaled Bernoulli draw), program failures (the slot is
wasted and the page re-placed), erase failures (the block is retired into
the bad-block map and charged against the spare pool), and the die-parity
rebuild of an uncorrectable read with its second-fault data-loss draw.

Every draw is a stateless counter hash keyed on what is failing, its
block's P/E count, the run's seed and a per-class stream, so a fault
schedule is a pure function of the state trajectory. The reference's
uint32 arithmetic is carried in int64 with each product masked back to 32
bits (as ``rber._hash_u32`` does): shifts on uint32 tensors are not
implemented on every backend, and the low 32 bits of an int64 product are
right even when it wraps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import ops
from repro_torch.core import modes

_U32 = 0xFFFFFFFF


class FaultParams(NamedTuple):
    """Resolved fault knobs for one run: 0-dim tensors on the state's device,
    except ``read_recovery_us`` and ``wear_power``, which are always static.
    ``max_read_retries < 0`` turns the retry-budget path off; rates of 0.0
    never draw a failure."""

    max_read_retries: torch.Tensor  # i32; < 0 = budget path off
    prog_fail_rate: torch.Tensor  # f32 probability per page program
    erase_fail_rate: torch.Tensor  # f32 probability per block erase
    read_fail_rate: torch.Tensor  # f32 probability per page read
    wear_slope: torch.Tensor  # f32 wear-curve gain; 0.0 = flat rates
    parity_rebuild: torch.Tensor  # i32 0/1; 1 = die-parity rebuild recovery
    seed: torch.Tensor  # i32 run-level stream selector
    read_recovery_us: float  # flat ECC soft-decode penalty
    wear_power: float  # wear-curve knee exponent


def _opt(value, default, dtype, device):
    """Knob field, falling back to the static config value when unset."""
    return ops.scalar(default if value is None else value, dtype, device)


@functools.cache
def _static_params(cfg, device) -> FaultParams:
    i32, f32 = torch.int32, torch.float32
    return FaultParams(
        max_read_retries=ops.scalar(cfg.max_read_retries, i32, device),
        prog_fail_rate=ops.scalar(cfg.prog_fail_rate, f32, device),
        erase_fail_rate=ops.scalar(cfg.erase_fail_rate, f32, device),
        read_fail_rate=ops.scalar(cfg.read_fail_rate, f32, device),
        wear_slope=ops.scalar(cfg.fault_wear_slope, f32, device),
        parity_rebuild=ops.scalar(int(cfg.parity_rebuild), i32, device),
        seed=ops.scalar(cfg.fault_seed, i32, device),
        read_recovery_us=cfg.read_recovery_us,
        wear_power=cfg.fault_wear_power,
    )


def params_for(cfg, knobs=None, device="cpu") -> FaultParams | None:
    """Resolve ``SimConfig`` + optional ``RunKnobs`` into fault parameters on
    ``device``, or ``None`` when fault injection is statically off (neither
    the config nor the knobs carry fault fields), so no fault op runs. The
    config's own bundle is made once per device."""
    has_knob_faults = knobs is not None and knobs.prog_fail_rate is not None
    if not (cfg.faults_enabled or has_knob_faults):
        return None
    device = torch.device(device)
    if not has_knob_faults:
        return _static_params(cfg, device)
    i32, f32 = torch.int32, torch.float32
    return FaultParams(
        max_read_retries=ops.scalar(knobs.max_read_retries, i32, device),
        prog_fail_rate=ops.scalar(knobs.prog_fail_rate, f32, device),
        erase_fail_rate=ops.scalar(knobs.erase_fail_rate, f32, device),
        read_fail_rate=_opt(knobs.read_fail_rate, cfg.read_fail_rate, f32, device),
        wear_slope=_opt(knobs.fault_wear_slope, cfg.fault_wear_slope, f32, device),
        parity_rebuild=_opt(knobs.parity_rebuild, int(cfg.parity_rebuild), i32, device),
        seed=ops.scalar(knobs.fault_seed, i32, device),
        read_recovery_us=cfg.read_recovery_us,
        wear_power=cfg.fault_wear_power,
    )


# draw-stream selectors: the fault classes never share a draw even when
# keyed on the same (id, pe) pair
STREAM_PROG = 0x50524F47  # "PROG"
STREAM_ERASE = 0x45525345  # "ERSE"
STREAM_READ = 0x52454144  # "READ"
STREAM_REBUILD = 0x52424C44  # "RBLD"


def _u32(x):
    """An integer tensor's value as the reference's uint32 (mod 2**32), in int64."""
    return torch.as_tensor(x).to(torch.int64) & _U32


def _mix(h):
    """One finalization round of the repo's xorshift-multiply hash (int64
    holding a uint32)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def uniform01(ident, cycle, seed, stream):
    """Stateless uniform (0, 1) float32 draw keyed on (id, P/E cycle, seed,
    stream), bit-exact with the reference's."""
    h = (_u32(ident) * 0x9E3779B9) & _U32
    h = _mix(h ^ ((_u32(cycle) * 0x68E31DA4) & _U32))
    h = _mix(h ^ ((_u32(seed) * 0xB5297A4D) & _U32) ^ stream)
    # (h & 0xFFFFFF) is exact in float32, and 2**-24 a power of two
    return ((h & 0xFFFFFF).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def block_entity(block, n_dies: int, planes: int):
    """Erase-fault entity of a block, keyed on its lattice coordinates
    ``(die, plane, index-within-plane)``; under the die-first striped
    layout it packs back to the raw block id."""
    die = block % n_dies
    plane = (block // n_dies) % planes
    idx = block // (n_dies * planes)
    return (idx * planes + plane) * n_dies + die


def wear_mult(p: FaultParams, pe, rated):
    """Wear-curve rate multiplier ``1 + slope * (pe / rated)^power`` in
    float32. The reference's compiled program fuses the multiply and add
    into one rounding (an FMA), so the port rounds once too, through
    float64, where a float32 product is exact. A slope of 0.0 gives exactly
    1.0."""
    frac = torch.clamp(torch.as_tensor(pe).float() / torch.as_tensor(rated).float(), min=0.0)
    term = p.wear_slope.double() * torch.pow(frac, p.wear_power).double()
    return (1.0 + term).float()


def prog_fails(p: FaultParams, slots, pe, rated):
    """Per-lane program-failure draw for slots about to be programmed."""
    rate = p.prog_fail_rate * wear_mult(p, pe, rated)
    return uniform01(slots, pe, p.seed, STREAM_PROG) < rate


def erase_fails(p: FaultParams, blocks, pe, rated):
    """Per-lane erase-failure draw for blocks about to be erased."""
    rate = p.erase_fail_rate * wear_mult(p, pe, rated)
    return uniform01(blocks, pe, p.seed, STREAM_ERASE) < rate


def read_fails(p: FaultParams, slots, pe, rated):
    """Per-lane probabilistic-uncorrectable draw for slots being read."""
    rate = p.read_fail_rate * wear_mult(p, pe, rated)
    return uniform01(slots, pe, p.seed, STREAM_READ) < rate


def rebuild_second_fault(p: FaultParams, slots, pe, rated, n_peers: int):
    """Second-uncorrectable-during-rebuild draw (true data loss): the stripe
    of ``n_peers`` peers is lost with ``1 - (1 - q)^n_peers``, ``q`` the
    wear-scaled read-fail rate; at ``read_fail_rate == 0`` it never fires."""
    q = torch.clamp(p.read_fail_rate * wear_mult(p, pe, rated), 0.0, 1.0)
    exponent = torch.full((), float(n_peers), dtype=torch.float32, device=q.device)
    loss_p = 1.0 - torch.pow(1.0 - q, exponent)
    return uniform01(slots, pe, p.seed, STREAM_REBUILD) < loss_p


def recovery_us(p: FaultParams, mode, cfg):
    """Victim-lane recovery time of one uncorrectable read, microseconds:
    the flat ECC constant, or with parity rebuild armed one sense at the
    victim's mode plus ``cfg.rebuild_xfer_chain`` serialized peer transfers.
    A one-die geometry has no stripe peers and always pays the flat one."""
    flat = torch.full(mode.shape, p.read_recovery_us, dtype=torch.float32, device=mode.device)
    if cfg.n_dies < 2:
        return flat
    xfer = torch.full((), cfg.rebuild_xfer_chain * cfg.transfer_us, dtype=torch.float32,
                      device=mode.device)
    rebuild = modes.table(modes.READ_LATENCY_US, mode.device)[mode.long()] + xfer
    return torch.where(p.parity_rebuild > 0, rebuild, flat)
