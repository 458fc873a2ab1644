"""Named scenario registry (DESIGN.md §7.2).

A *scenario* is any callable ``(cfg, n_requests, seed, **kw) -> trace`` where
``trace`` is the engine's packed ``{"lpn": (C, chunk), "op": (C, chunk)}``
dict. Generators register themselves by name so the sweep runner, the
benchmark harness and the CLI all share one namespace; the classic
``workload`` generators are registered here too so old and new workloads are
uniformly addressable.

Counterpart of ``repro.experiments.registry``: the same names, the same
builders.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.ssdsim import geometry, workload

SCENARIOS: dict[str, Callable] = {}
_SEED_INVARIANT: set[str] = set()


def register(name: str, seed_invariant: bool = False):
    """Decorator: register a trace builder under ``name`` (unique).

    ``seed_invariant`` marks builders whose trace does not depend on the
    seed (e.g. deterministic replay); the sweep runner warns when such a
    scenario is swept over multiple seeds, since the runs would be
    duplicates reported as seed variance.
    """

    def deco(fn: Callable) -> Callable:
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = fn
        if seed_invariant:
            _SEED_INVARIANT.add(name)
        return fn

    return deco


def is_seed_invariant(name: str) -> bool:
    return name in _SEED_INVARIANT


def names() -> list[str]:
    return sorted(SCENARIOS)


def build(name: str, cfg: geometry.SimConfig, n_requests: int, seed: int = 0, **kw):
    """Build the named scenario's packed trace."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have {names()}") from None
    return fn(cfg, n_requests, seed=seed, **kw)


# --- classic single-distribution workloads, re-exported by name ------------

@register("zipf")
def _zipf(cfg, n_requests, seed=0, theta=1.2, **kw):
    return workload.zipf_read_trace(cfg, n_requests, theta, seed=seed, **kw)


@register("uniform")
def _uniform(cfg, n_requests, seed=0):
    return workload.uniform_read_trace(cfg, n_requests, seed=seed)


@register("seq", seed_invariant=True)
def _seq(cfg, n_requests, seed=0, start=0):
    return workload.seq_read_trace(cfg, n_requests, start=start)


@register("mixed")
def _mixed(cfg, n_requests, seed=0, theta=1.2, read_frac=0.7):
    return workload.mixed_trace(cfg, n_requests, theta, read_frac=read_frac, seed=seed)
