"""Victim scoring and elastic capacity recovery (paper §IV-E, Fig. 12).

Counterpart of ``repro.core.reclaim``: every victim selection of the
simulator goes through :func:`score_victims` (GC victim picking and reclaim
demotion share one top-k lane core).

Objectives: ``"min_valid"`` (fewest valid pages first), ``"lifespan"``
(``α·invalid_ratio − β·migration_cost − γ·pe_normalized``) and
``"demotion"`` (the coldest low-density blocks back toward QLC, only under
free-space pressure). The GC objective can also come per run as a
``RunKnobs.gc_objective`` code.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from repro_torch import ops
from repro_torch.core import modes

GC_MIN_VALID = "min_valid"
GC_LIFESPAN = "lifespan"
DEMOTION = "demotion"
GC_OBJECTIVES = (GC_MIN_VALID, GC_LIFESPAN)
GC_OBJECTIVE_CODES = {GC_MIN_VALID: 0, GC_LIFESPAN: 1}

_DEPRECATED_WARNED: set[str] = set()


def _warn_deprecated(name: str) -> None:
    if name in _DEPRECATED_WARNED:
        return
    _DEPRECATED_WARNED.add(name)
    warnings.warn(
        f"reclaim.{name} is deprecated; use reclaim.score_victims(...)",
        DeprecationWarning, stacklevel=3,
    )


class ReclaimConfig(NamedTuple):
    # Demote only when free capacity fraction drops below this watermark.
    low_watermark: float = 0.15
    # Stop demoting once free capacity recovers to this level.
    high_watermark: float = 0.25
    # A block is demotable only if it stayed COLD this many epochs.
    cold_epochs: int = 4
    # Cap on demotions per recovery pass (bounds write amplification).
    max_per_pass: int = 8


def demotion_scores(block_mode, block_heat, cold_age):
    """Demotion scores (larger = better candidate; -inf for ineligible, i.e.
    QLC, blocks): cold age first, residual heat breaks ties (colder wins).

    The reference's compiled program fuses ``cold - 1e-3 * heat`` into one
    rounding (an FMA); the port rounds once too, through float64, where the
    float32 product is exact."""
    eligible = block_mode.to(torch.int32) < modes.QLC
    c = torch.full((), 1e-3, dtype=torch.float32, device=block_heat.device).double()
    score = (cold_age.float().double() - c * block_heat.float().double()).float()
    return torch.where(eligible, score, -torch.inf)


def _topk(scores, eligible, k: int):
    """Top-k victim lanes over ``eligible``-masked float scores: ``k`` block
    ids best-first (ties to the lowest block id) and the lanes that hold an
    eligible block."""
    masked = torch.where(eligible, scores.float(), -torch.inf)
    vals, victims = ops.top_k(masked, k)
    return victims, vals > -torch.inf


def _demotion_select(block_mode, block_heat, cold_age, free_frac, cfg: ReclaimConfig):
    """Demotion selection core: scores, hysteresis, watermark, top-k, and a
    one-level target for each victim."""
    scores = demotion_scores(block_mode, block_heat, cold_age)
    eligible = (scores > -torch.inf) & (cold_age >= cfg.cold_epochs)
    under_pressure = torch.as_tensor(free_frac) < cfg.low_watermark

    k = min(cfg.max_per_pass, block_mode.shape[-1])
    victims, ok = _topk(scores, eligible & under_pressure, k)
    target = torch.clamp(block_mode.to(torch.int32)[victims.long()] + 1, max=modes.QLC)
    return victims, ok, target


def gc_scores(s, cfg, objective: str = GC_MIN_VALID, objective_code=None):
    """Per-block GC victim scores (larger = better victim). A traced
    ``objective_code`` selects the formula per run; else the static
    ``objective``."""
    min_valid = -s.block_valid.float()
    if objective_code is None and objective == GC_MIN_VALID:
        return min_valid

    from repro_torch.ssdsim import geometry  # deferred: core stays importable alone

    dev = s.block_mode.device
    mode = s.block_mode.long()
    pages = geometry.pages_per_block(cfg, dev)[mode].float()
    migration_cost = s.block_valid.float() / pages
    invalid_ratio = 1.0 - migration_cost
    pe_norm = s.block_pe.float() / modes.table(modes.PE_LIMIT, dev)[mode].float()
    # α·invalid − β·cost − γ·pe_norm with the reference's roundings: its
    # compiled program fuses each subtraction with the multiply before it
    # into an FMA, which the port takes through float64 (exact products)
    alpha, beta, gamma = (torch.full((), v, dtype=torch.float32, device=dev).double()
                          for v in (cfg.gc_alpha, cfg.gc_beta, cfg.gc_gamma))
    b_cost = (beta * migration_cost.double()).float().double()
    head = (alpha * invalid_ratio.double() - b_cost).float().double()
    lifespan = (head - gamma * pe_norm.double()).float()
    if objective_code is None:
        return lifespan
    code = ops.scalar(objective_code, torch.int32, dev)
    return torch.where(code == GC_OBJECTIVE_CODES[GC_LIFESPAN], lifespan, min_valid)


def score_victims(s, cfg, objective: str = GC_MIN_VALID, *, k: int | None = None,
                  block_heat=None, free_frac=None, reclaim_cfg: ReclaimConfig | None = None,
                  objective_code=None):
    """Unified victim selection over an ``SSDState``: ``(victims, ok,
    target)``, block-id lanes best-first, a validity mask, and each
    victim's destination mode (its own for GC, one density level down for
    demotion). GC objectives need ``k``; ``"demotion"`` needs
    ``block_heat``, ``free_frac`` and ``reclaim_cfg``."""
    if objective == DEMOTION:
        if block_heat is None or free_frac is None or reclaim_cfg is None:
            raise ValueError("demotion objective needs block_heat, free_frac, reclaim_cfg")
        from repro_torch.ssdsim import state as st  # deferred, as above

        # open (partially written) low-density blocks are not demotable
        eligible_mode = torch.where(s.block_state == st.FULL, s.block_mode, modes.QLC)
        return _demotion_select(eligible_mode, block_heat, s.block_cold_age,
                                free_frac, reclaim_cfg)

    if objective not in GC_OBJECTIVES:
        raise ValueError(f"unknown victim objective {objective!r}")
    if k is None:
        raise ValueError("GC objectives need an explicit k")
    from repro_torch.ssdsim import geometry, state as st  # deferred, as above

    ppb = geometry.pages_per_block(cfg, s.block_mode.device)
    reclaimable = (s.block_state == st.FULL) & (s.block_valid < ppb[s.block_mode.long()])
    scores = gc_scores(s, cfg, objective, objective_code)
    victims, ok = _topk(scores, reclaimable, k)
    target = s.block_mode[victims.long()]  # GC relocates at the victim's own density
    return victims, ok, target


# ---------------------------------------------------------------------------
# Deprecated wrappers (pre-score_victims API), kept callable; each warns once.
# ---------------------------------------------------------------------------

def select_demotions(block_mode, block_heat, cold_age, free_frac, cfg: ReclaimConfig):
    """Deprecated dense-mask demotion API — use :func:`score_victims`.
    Returns (mask, target_mode) over all blocks."""
    _warn_deprecated("select_demotions")
    victims, ok, _ = _demotion_select(block_mode, block_heat, cold_age, free_frac, cfg)
    n_blocks = block_mode.shape[-1]
    mask = ops.at_set(torch.zeros((n_blocks,), dtype=torch.bool, device=block_mode.device),
                      torch.where(ok, victims, n_blocks), True)
    target = torch.where(mask, torch.clamp(block_mode.to(torch.int32) + 1, max=modes.QLC),
                         block_mode)
    return mask, target


def topk_victims(scores, eligible, k: int):
    """Deprecated — use :func:`score_victims` (or its ``_topk`` core)."""
    _warn_deprecated("topk_victims")
    return _topk(scores, eligible, k)


def select_demotion_victims(block_mode, block_heat, cold_age, free_frac,
                            cfg: ReclaimConfig):
    """Deprecated lane-based demotion API — use
    ``score_victims(s, cfg, "demotion", ...)``."""
    _warn_deprecated("select_demotion_victims")
    return _demotion_select(block_mode, block_heat, cold_age, free_frac, cfg)
