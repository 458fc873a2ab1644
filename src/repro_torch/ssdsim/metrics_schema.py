"""Single metrics-schema registry: name → (unit, description, scalar).

A copy of ``repro.ssdsim.metrics_schema`` (the port's ``engine.summarize``
emits the same keys).

One source of truth for every key ``engine.summarize`` can emit.
``sweep._ROW_UNITS`` (the flattening of run results into harness-style
``(name, value, unit)`` rows) and the ``benchmarks/report.py`` renderers
both derive their units from here, so a new metric — e.g. the §2E
endurance rows — registers in exactly one place. A tier-1 test pins
``summarize`` output keys ⊆ this schema at every ``obs_level``.

``scalar=False`` marks nested-list metrics (per-mode / matrix shapes)
that cannot flatten into a single sweep row; :func:`row_units` excludes
them. Insertion order of the scalar entries is the row order of sweep
artifacts — append, don't reorder.
"""

from __future__ import annotations

from typing import NamedTuple


class Metric(NamedTuple):
    unit: str
    description: str
    scalar: bool = True


SCHEMA: dict[str, Metric] = {
    # ---- throughput / latency ----
    "iops": Metric("IOPS", "read throughput over the device makespan"),
    "mean_read_latency_us": Metric("us", "mean recorded user-read latency"),
    "read_lat_p50_us": Metric("us", "read latency 50th percentile"),
    "read_lat_p95_us": Metric("us", "read latency 95th percentile"),
    "read_lat_p99_us": Metric("us", "read latency 99th percentile"),
    "read_lat_p999_us": Metric("us", "read latency 99.9th percentile"),
    "write_lat_p50_us": Metric("us", "write latency 50th percentile"),
    "write_lat_p95_us": Metric("us", "write latency 95th percentile"),
    "write_lat_p99_us": Metric("us", "write latency 99th percentile"),
    "write_lat_p999_us": Metric("us", "write latency 99.9th percentile"),
    "read_queue_delay_us": Metric("us", "mean per-read die queueing delay (open loop)"),
    "read_chan_wait_us": Metric("us", "mean per-read channel-bus wait (lattice model)"),
    "retries_per_read": Metric("retries", "mean read-retry senses per read"),
    # ---- capacity / relocation ----
    "capacity_gib": Metric("GiB", "usable capacity at current block modes"),
    "capacity_loss_gib": Metric("GiB", "capacity surrendered to low-density modes"),
    "migrated_pages": Metric("pages", "pages moved by conversion/GC/reclaim"),
    "erases": Metric("erases", "block erases performed"),
    "conversions": Metric("conversions", "(3,3) from-mode x to-mode block conversions",
                          scalar=False),
    "reads": Metric("reads", "user reads served"),
    "writes": Metric("writes", "user pages written"),
    # ---- faults (DESIGN.md §2D) ----
    "uncorrectable_reads": Metric("reads", "reads past the retry budget (ECC recovery)"),
    "prog_fails": Metric("failures", "failed page programs (re-placed)"),
    "erase_fails": Metric("failures", "failed erases (block retired)"),
    "dropped_writes": Metric("writes", "writes lost to allocation exhaustion"),
    "bad_blocks": Metric("blocks", "blocks retired to the bad-block map"),
    # ---- endurance / WAF (DESIGN.md §2E) ----
    "user_pages": Metric("pages", "host page programs (the WAF denominator)"),
    "reloc_pages": Metric("pages", "physical relocation programs (ftl._place_pages)"),
    "waf": Metric("ratio", "write amplification = (user + reloc) / user pages"),
    "pe_mean": Metric("cycles", "mean P/E count over live blocks"),
    "pe_variance": Metric("cycles^2", "P/E-count variance over live blocks "
                                      "(wear-levelling quality)"),
    "pe_max": Metric("cycles", "worst-block P/E count"),
    "pe_mean_by_mode": Metric("cycles", "(3,) mean P/E per current block mode",
                              scalar=False),
    "tbw_gib": Metric("GiB", "projected total-bytes-written at rated QLC "
                             "endurance over measured WAF"),
    "dwpd": Metric("DWPD", "drive writes per day at the observed host rate"),
    "lifetime_years": Metric("years", "projected years to rated wear at the "
                                      "observed host rate (0 = no host writes)"),
    # ---- observability (DESIGN.md §7.4) ----
    "lat_mode_counts": Metric("reads", "(3, N_LAT_BINS) per-mode read histogram",
                              scalar=False),
    "lat_attrib_us": Metric("us", "(3, N_COMPONENTS) latency attribution sums",
                            scalar=False),
    "tail_retry_share": Metric("share", "(3,) retry share of each mode's p99 tail",
                               scalar=False),
    "conversion_events": Metric("conversions", "(3,3) conversions decoded from the "
                                               "event ring", scalar=False),
    "obs_events_total": Metric("events", "events emitted into the ring"),
    "obs_events_dropped": Metric("events", "ring overwrites (capacity overflow)"),
    # ---- wear-correlated faults / rebuild / spare pool (DESIGN.md §2D) ----
    "rebuilds": Metric("rebuilds", "die-parity stripe rebuilds of uncorrectable reads"),
    "data_loss": Metric("stripes", "second fault during rebuild: unreconstructable"),
    "degraded_writes": Metric("writes", "host writes refused in read-only degraded mode"),
    "spares_total": Metric("blocks", "over-provisioning spare pool size (-1 = unbounded)"),
    "spares_remaining": Metric("blocks", "spare blocks left (-1 = unbounded)"),
    "spare_covered_gib": Metric("GiB", "retired capacity backfilled by the spare pool"),
    "effective_capacity_gib": Metric("GiB", "usable capacity incl. spare-pool backfill"),
    "degraded": Metric("flag", "1.0 = spare pool exhausted, device read-only"),
}


def units() -> dict[str, str]:
    """name → unit for every registered metric."""
    return {k: m.unit for k, m in SCHEMA.items()}


def row_units() -> dict[str, str]:
    """name → unit for scalar metrics only — the sweep-row flattening order."""
    return {k: m.unit for k, m in SCHEMA.items() if m.scalar}


def describe(name: str) -> Metric:
    return SCHEMA[name]
