"""The paper's own system config: FEMU-emulated hybrid SSD presets
(Table III geometry) at the three wear stages, and the experiment grids
built on them.

Counterpart of ``repro.configs.raro_ssd``, with the same presets and the
same grids; each builder returns the port's ``experiments.sweep.SweepSpec``,
which ``run_sweep`` runs one run after another on one device.
"""
from repro_torch.ssdsim.geometry import BASELINE, HOTNESS, RARO, SimConfig  # noqa: F401

YOUNG = SimConfig(policy=RARO, initial_pe=166, device_age_h=24.0)
MIDDLE = SimConfig(policy=RARO, initial_pe=500, device_age_h=24.0)
OLD = SimConfig(policy=RARO, initial_pe=833, device_age_h=24.0)
STAGES = {"young": YOUNG, "middle": MIDDLE, "old": OLD}
STAGE_PE = {"young": 166, "middle": 500, "old": 833}

# the small high-occupancy geometry of the endurance and wear-out grids, on
# which GC fires constantly under a write-heavy trace
_ENDURANCE_BASE = dict(
    blocks_per_plane=64, slots_per_block=256, n_logical=57_344,
    chunk=256, migrate_pages_per_chunk=64,
    max_conversions_per_chunk=4, gc_free_threshold=24,
    gc_victims_per_pass=8, device_age_h=24.0,
)


def tail_latency_sweep(scenario: str = "read_disturb_hammer",
                       n_requests: int = 80_000,
                       stages=("young", "old"), seeds=(0, 1)):
    """Canonical tail-latency experiment grid (paper Figs. 13-18 axes):
    baseline-vs-RARO across wear stages and seeds."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=tuple(STAGE_PE[s] for s in stages),
        seeds=tuple(seeds),
        base=SimConfig(device_age_h=24.0),
    )


def sharded_sweep(scenario: str = "read_disturb_hammer",
                  n_requests: int = 80_000,
                  stages=("young", "middle", "old"), seeds=(0, 1, 2, 3)):
    """The reference's device-sharded grid: 3 wear stages x 4 seeds = 12 runs
    per policy group. The port runs it on one device (``run_sweep`` refuses
    more than one; see ``sweep.resolve_devices``)."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=tuple(STAGE_PE[s] for s in stages),
        seeds=tuple(seeds),
        base=SimConfig(device_age_h=24.0),
    )


def fault_storm_sweep(scenario: str = "fault_storm",
                      n_requests: int = 40_000,
                      prog_fail_rate=(0.0, 0.005),
                      erase_fail_rate=(0.02,),
                      max_read_retries: int = 10,
                      stage: str = "old", seeds=(0,)):
    """Failure-mode experiment grid (DESIGN.md §2D): the write-heavy
    ``fault_storm`` trace on a worn device, swept over program-failure rates
    with erase failures retiring blocks and a finite read-retry budget. The
    fault-free point (rate 0.0) runs through the fault knobs too and stays
    bit-identical to a fault-free run."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=(STAGE_PE[stage],),
        seeds=tuple(seeds),
        prog_fail_rate=tuple(prog_fail_rate),
        erase_fail_rate=tuple(erase_fail_rate),
        max_read_retries=(max_read_retries,),
        base=SimConfig(device_age_h=24.0),
    )


def endurance_sweep(scenario: str = "fault_storm",
                    n_requests: int = 24_576,
                    stages=("young", "old"), seeds=(0,),
                    gc_objectives=("min_valid", "lifespan")):
    """Multi-objective endurance grid (DESIGN.md §2E): {baseline, RARO} ×
    {min-valid GC, lifespan-aware GC} × wear stages on a write-heavy trace
    over a small high-occupancy geometry, so GC fires constantly and the
    WAF / P/E-variance / lifetime rows discriminate: the read-p99 vs WAF vs
    projected-lifetime frontier. The ``gc_objective`` axis rides
    ``RunKnobs.gc_objective``."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=tuple(STAGE_PE[s] for s in stages),
        seeds=tuple(seeds),
        gc_objective=tuple(gc_objectives),
        base=SimConfig(**_ENDURANCE_BASE),
    )


def wearout_sweep(scenario: str = "fault_storm",
                  n_requests: int = 24_576,
                  stages=("young", "old"), seeds=(0,),
                  fault_wear_slope=(0.0, 8.0),
                  gc_objectives=("min_valid", "lifespan"),
                  spare_blocks: int = 12):
    """Wear-correlated failure frontier (DESIGN.md §2D): {baseline, RARO} ×
    {min-valid, lifespan GC} × {flat, wear-correlated rates} × drive age on
    the endurance geometry, with die-parity rebuild armed and a finite
    spare pool, so erase failures retire blocks and drain spares,
    uncorrectable reads trigger stripe rebuilds (second faults count as
    data loss), and pool exhaustion flips the drive read-only. The
    flat-rate points (``fault_wear_slope = 0``) pin the flat-rate
    behavior."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=tuple(STAGE_PE[s] for s in stages),
        seeds=tuple(seeds),
        prog_fail_rate=(0.002,),
        erase_fail_rate=(0.02,),
        max_read_retries=(8,),
        read_fail_rate=(0.0005,),
        fault_wear_slope=tuple(fault_wear_slope),
        parity_rebuild=(True,),
        spare_blocks=(spare_blocks,),
        gc_objective=tuple(gc_objectives),
        base=SimConfig(**_ENDURANCE_BASE),
    )


def latency_load_sweep(scenario: str = "hammer_openloop",
                       n_requests: int = 80_000,
                       rate_iops: float = 50_000.0,
                       arrival_scale=(0.25, 0.5, 1.0, 2.0, 4.0),
                       stage: str = "old", seeds=(0,)):
    """Latency-vs-offered-load experiment grid: one open-loop retry-heavy
    trace at a base Poisson ``rate_iops``, swept over offered-load
    multipliers through ``RunKnobs.arrival_scale``, so the whole
    hockey-stick curve (per policy) shares one trace."""
    from repro_torch.experiments.sweep import SweepSpec

    return SweepSpec(
        scenario=scenario,
        n_requests=n_requests,
        policies=(BASELINE, RARO),
        initial_pe=(STAGE_PE[stage],),
        seeds=tuple(seeds),
        arrival_scale=tuple(arrival_scale),
        scenario_kw=(("rate_iops", rate_iops),),
        base=SimConfig(device_age_h=24.0),
    )
