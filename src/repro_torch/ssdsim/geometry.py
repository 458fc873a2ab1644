"""Emulated-SSD geometry and simulation configuration (paper Table III).

A copy of ``repro.ssdsim.geometry`` (host-side Python), whose
``pages_per_block`` gives its table as a tensor on a device.

Default geometry: 2 channels x 2 dies/channel x 1 plane x 256 blocks/plane,
16 KiB pages, 256/768/1024 pages per SLC/TLC/QLC block -> 16 GiB raw QLC
capacity; the paper's working set is 8 GiB (524,288 logical pages).

Resource lattice (DESIGN.md §2C): timing resources form a
``(channel, die, plane)`` hierarchy. A *die* (what ONFI calls a LUN) owns
sense/program/erase occupancy; the *channel* bus it hangs off serializes
page transfers across its dies; *planes* within a die can co-schedule
program/erase and overlap. Block ids interleave die-first —
``die = block % n_dies``, ``plane = (block // n_dies) % planes_per_lun`` —
so consecutive blocks stripe across dies exactly like the historical
``blk % n_luns`` LUN striping (``n_dies == n_luns``; the block -> die map is
unchanged, which is what keeps the legacy timing model reachable
bit-for-bit).

``chan_model`` selects the timing model: ``"legacy"`` (default) is the
one-clock-per-LUN scheduler — transfer never queues — and ``"lattice"``
adds per-channel transfer clocks and multi-plane overlap.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace

from repro_torch.core import hotness, modes

CHAN_MODELS = ("legacy", "lattice")

# Statically configurable GC victim objectives. Mirrors
# reclaim.GC_OBJECTIVES (kept as a literal here so the config layer stays
# importable alone; cross-checked by tests/test_torch_ssd_host.py).
GC_OBJECTIVES = ("min_valid", "lifespan")

# Free-block allocation policies: "lowest_id" is the historical
# first-free-id scan (pinned bit-identical); "youngest" steers allocation
# toward the lowest-P/E free block (wear-levelled allocation — the other
# half of wear levelling next to the lifespan GC victim scorer).
ALLOC_POLICIES = ("lowest_id", "youngest")

_ALIAS_WARNED: set[str] = set()

BASELINE = 0  # multi-read-retry QLC, no mode awareness
HOTNESS = 1  # temperature-only 3-mode conversion (paper's comparison)
RARO = 2  # this paper
POLICY_NAMES = ("baseline", "hotness", "raro")


@dataclass(frozen=True)
class SimConfig:
    # --- Table III geometry ---
    n_channels: int = 2
    luns_per_channel: int = 2
    planes_per_lun: int = 1
    blocks_per_plane: int = 256
    page_kib: int = 16
    slots_per_block: int = 1024  # physical wordline slots == QLC page count

    # --- workload footprint ---
    n_logical: int = 524_288  # 8 GiB of 16 KiB pages

    # --- engine ---
    chunk: int = 1024  # requests per vectorized step (FTL background period)
    migrate_pages_per_chunk: int = 128  # page-granular conversion budget/mode
    max_conversions_per_chunk: int = 4  # block-granular ops (GC/reclaim)
    gc_free_threshold: int = 8  # min free blocks before GC kicks in
    gc_victims_per_pass: int = 4  # blocks relocated per fused GC firing
    device_age_h: float = 100.0  # retention baseline (pre-aged device)
    channel_mb_s: float = 800.0  # ONFI channel bandwidth for page transfer
    # timing model (DESIGN.md §2C): "legacy" = one opaque clock per LUN,
    # transfer appended to latency but never queued (the historical model);
    # "lattice" = two-resource (die, channel) tandem queue with per-channel
    # transfer clocks and multi-plane program/erase overlap
    chan_model: str = "legacy"

    # --- observability (DESIGN.md §7.4) ---
    # "off": no obs ops traced at all (zero-length accumulator leaves);
    # "counters": per-mode latency count histograms + windowed time series;
    # "full": + per-component latency decomposition + the event ring buffer.
    obs_level: str = "off"
    obs_event_capacity: int = 256  # ring slots (overwrite-oldest beyond)
    obs_windows: int = 64  # time-series windows (last absorbs overflow)
    obs_window_ms: float = 50.0  # simulated time per window

    # --- fault injection (DESIGN.md §2D) ---
    # max_read_retries < 0: every read eventually decodes (the optimistic
    # pre-fault model). >= 0: a read whose Eq.-3 retry count exceeds the
    # budget is uncorrectable — it burns the budget, pays read_recovery_us
    # of ECC soft-decode/recovery, and increments n_uncorrectable. Only
    # budgets below the mode's retry-table limit (modes.MAX_RETRIES) can
    # fire, since page_retries clips at the table.
    max_read_retries: int = -1
    read_recovery_us: float = 5000.0  # flat ECC soft-decode penalty
    prog_fail_rate: float = 0.0  # per page program (user write path)
    erase_fail_rate: float = 0.0  # per block erase -> bad-block retirement
    read_fail_rate: float = 0.0  # per page read -> probabilistic uncorrectable
    fault_seed: int = 0  # stream selector for the deterministic draws
    # wear curve: every fault rate scales by 1 + slope*(pe/rated)^power,
    # evaluated per operation from the failing block's P/E count. Slope 0.0
    # (default) gives exactly the flat rates.
    fault_wear_slope: float = 0.0
    fault_wear_power: float = 4.0
    # uncorrectable-recovery model: False = flat read_recovery_us penalty;
    # True = die-parity stripe rebuild (peer senses + serialized channel
    # transfers, charged on the timing lattice) with a second-fault path
    # counting true data loss
    parity_rebuild: bool = False
    # over-provisioning spare pool: erase-fail retirements consume spares
    # before eating usable capacity; 0 remaining flips the engine into
    # read-only degraded mode (writes dropped + counted, mapping intact).
    # < 0 = unbounded pool.
    spare_blocks: int = -1

    # --- GC victim objective (DESIGN.md §2E) ---
    # "min_valid": classic fewest-valid-pages-first (the pinned default);
    # "lifespan": score = α·invalid_ratio − β·migration_cost − γ·pe_norm,
    # trading a little immediate harvest for flatter wear. Also selectable
    # per-run as a traced RunKnobs sweep axis (RunKnobs.gc_objective).
    gc_objective: str = "min_valid"
    gc_alpha: float = 1.0
    gc_beta: float = 0.5
    gc_gamma: float = 0.3

    # --- free-block allocation policy (wear levelling) ---
    # "lowest_id": historical first-free-id scan (pinned bit-identical);
    # "youngest": lowest-P/E free block first (die affinity still wins,
    # ties break to the lowest id).
    alloc_policy: str = "lowest_id"

    # --- policy ---
    policy: int = RARO
    r1: int = 1
    r2_override: int = -1  # <0: use the paper's stage schedule (5/7/11)
    heat: hotness.HeatConfig = field(default_factory=hotness.HeatConfig)
    reclaim_enabled: bool = True

    # --- initial wear (paper evaluates young/middle/old devices) ---
    initial_pe: int = 166

    def __post_init__(self):
        if self.chan_model not in CHAN_MODELS:
            raise ValueError(
                f"chan_model must be one of {CHAN_MODELS}, "
                f"got {self.chan_model!r}"
            )
        if self.gc_objective not in GC_OBJECTIVES:
            raise ValueError(
                f"gc_objective must be one of {GC_OBJECTIVES}, "
                f"got {self.gc_objective!r}"
            )
        if self.alloc_policy not in ALLOC_POLICIES:
            raise ValueError(
                f"alloc_policy must be one of {ALLOC_POLICIES}, "
                f"got {self.alloc_policy!r}"
            )
        if self.fault_wear_power <= 0.0:
            raise ValueError(
                f"fault_wear_power must be > 0, got {self.fault_wear_power}"
            )

    @property
    def n_luns(self) -> int:
        return self.n_channels * self.luns_per_channel

    @property
    def n_dies(self) -> int:
        """Dies in the device — one die per historical LUN (``n_dies ==
        n_luns``; "LUN" is ONFI's name for a die, kept as the legacy
        alias)."""
        return self.n_channels * self.luns_per_channel

    @property
    def planes_per_die(self) -> int:
        return self.planes_per_lun

    @property
    def n_blocks(self) -> int:
        return self.n_luns * self.planes_per_lun * self.blocks_per_plane

    @property
    def n_slots(self) -> int:
        return self.n_blocks * self.slots_per_block

    @property
    def page_bytes(self) -> int:
        return self.page_kib * 1024

    @property
    def faults_enabled(self) -> bool:
        """Static gate: any fault class configured on the config itself. (A run
        can also arm faults through ``RunKnobs`` fields — see
        ``repro_torch.core.faults.params_for``.)"""
        return (self.max_read_retries >= 0 or self.prog_fail_rate > 0.0
                or self.erase_fail_rate > 0.0 or self.read_fail_rate > 0.0)

    @property
    def transfer_us(self) -> float:
        """Channel transfer time of one page (16 KiB @ 800 MB/s ~= 20 us)."""
        return self.page_bytes / (self.channel_mb_s * 1e6) * 1e6

    @property
    def rebuild_xfer_chain(self) -> int:
        """Serialized peer transfers on a die-parity rebuild's critical path.

        A rebuild reads the victim page's ``n_dies - 1`` stripe peers; their
        senses overlap across dies but every peer page must cross a channel
        bus. With multiple channels the peers split evenly across buses
        (dies stripe across channels), so the busiest bus carries
        ``luns_per_channel`` transfers; on a single channel all peers
        serialize behind each other."""
        if self.n_channels > 1:
            return self.luns_per_channel
        return max(self.n_dies - 1, 0)

    # --- lattice indexing (works on python ints and traced arrays) ---

    def die_of_block(self, block):
        """Owning die of a block: blocks stripe die-first, so consecutive
        block ids land on consecutive dies (identical to the historical
        ``blk % n_luns`` LUN striping)."""
        return block % self.n_dies

    def plane_of_block(self, block):
        """Plane within its die: after the die stripe, blocks cycle through
        the die's planes."""
        return (block // self.n_dies) % self.planes_per_die

    def channel_of_die(self, die):
        """Channel bus a die hangs off (dies stripe across channels)."""
        return die % self.n_channels

    def plane_slot_of_block(self, block):
        """Flattened ``die * planes_per_die + plane`` index — the segment id
        for per-(die, plane) reductions (reshape to ``(n_dies, planes)``)."""
        return self.die_of_block(block) * self.planes_per_die + \
            self.plane_of_block(block)

    def lun_of_block(self, block):
        """Deprecated legacy alias — use :meth:`die_of_block` (the
        historical LUN of a block is its die). Warns once per process; no
        ``src/`` module may call it (grep-enforced by tests)."""
        if "lun_of_block" not in _ALIAS_WARNED:
            _ALIAS_WARNED.add("lun_of_block")
            warnings.warn("SimConfig.lun_of_block is deprecated; use die_of_block",
                          DeprecationWarning, stacklevel=2)
        return self.die_of_block(block)

    def channel_of_lun(self, lun):
        """Deprecated legacy alias — use :meth:`channel_of_die`. Warns once
        per process; no ``src/`` module may call it (grep-enforced)."""
        if "channel_of_lun" not in _ALIAS_WARNED:
            _ALIAS_WARNED.add("channel_of_lun")
            warnings.warn("SimConfig.channel_of_lun is deprecated; use channel_of_die",
                          DeprecationWarning, stacklevel=2)
        return self.channel_of_die(lun)

    def with_policy(self, policy: int) -> "SimConfig":
        return replace(self, policy=policy)


def tiny_config(**kw) -> SimConfig:
    """Small geometry for unit tests (fast on CPU)."""
    base = dict(
        n_channels=2,
        luns_per_channel=2,
        blocks_per_plane=16,
        slots_per_block=64,
        page_kib=16,
        n_logical=1536,
        chunk=128,
        migrate_pages_per_chunk=16,
        max_conversions_per_chunk=2,
        gc_free_threshold=2,
        gc_victims_per_pass=2,
    )
    base.update(kw)
    return SimConfig(**base)


# Pages per block if the block were opened in each mode, scaled to the
# configured slots_per_block (Table III ratios 256:768:1024).
def pages_per_block(cfg: SimConfig, device):
    """(3,) int32 pages per block of each mode, on ``device``: the host
    table of :func:`pages_per_block_host` (the reference computes the same
    float32 ratios on the device and rounds them the same way), made once
    per device."""
    return modes.table(tuple(int(v) for v in pages_per_block_host(cfg)), device)


def pages_per_block_host(cfg: SimConfig):
    """Host-side (numpy) pages per block of each mode, for static unroll
    bounds: float32 ratios to the QLC count, times ``slots_per_block``."""
    import numpy as np

    ppb = np.asarray(modes.PAGES_PER_BLOCK, np.int32)
    ratio = ppb.astype(np.float32) / np.float32(ppb[modes.QLC])
    return np.maximum((ratio * cfg.slots_per_block).astype(np.int32), 1)
