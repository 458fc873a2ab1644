"""RARO migration principles — Table II of the paper.

Counterpart of ``repro.core.policy``.

| NAND | Access frequency | Retry count        | Conversion |
|------|------------------|--------------------|------------|
| QLC  | Hot              | >= R1              | QLC -> SLC |
| QLC  | Warm             | >= R2 (R2 >= R1)   | QLC -> TLC |
| TLC  | Hot              | >= R1              | TLC -> SLC |
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import modes

# Paper §V-C: R1 = 1 because freshly converted TLC needs <= 1 retry.
DEFAULT_R1 = 1
# Paper Fig. 17/18 conclusion: R2 = 5 / 7 / 11 per wear stage.
R2_BY_STAGE = (5, 7, 11)


class Thresholds(NamedTuple):
    r1: int | torch.Tensor  # scalar or per-element
    r2: int | torch.Tensor  # scalar or per-element (r2 >= r1)


def migration_decision(mode, heat_cls, retries, th: Thresholds):
    """Table II, element-wise: the target mode of every entry (int32).
    Entries that do not trigger keep their current mode."""
    mode = mode.to(torch.int32)
    heat_cls = heat_cls.to(torch.int32)
    retries = retries.to(torch.int32)

    qlc_hot = (mode == modes.QLC) & (heat_cls == modes.HOT) & (retries >= th.r1)
    qlc_warm = (mode == modes.QLC) & (heat_cls == modes.WARM) & (retries >= th.r2)
    tlc_hot = (mode == modes.TLC) & (heat_cls == modes.HOT) & (retries >= th.r1)

    target = torch.where(qlc_warm, modes.TLC, mode)
    # QLC->SLC takes precedence over QLC->TLC.
    target = torch.where(qlc_hot, modes.SLC, target)
    target = torch.where(tlc_hot, modes.SLC, target)
    return target.to(torch.int32)


def stage_thresholds(pe_cycles, r1: int = DEFAULT_R1) -> Thresholds:
    """Per-element thresholds with the paper's stage-adaptive R2 schedule."""
    stage = modes.stage_of(pe_cycles)
    return Thresholds(r1, modes.table(R2_BY_STAGE, stage.device)[stage.long()])


def hotness_only_decision(mode, heat_cls):
    """The paper's 'Hotness' comparison scheme: temperature-only 3-mode
    conversion, ignoring retry counts (the capacity-loss baseline)."""
    mode = mode.to(torch.int32)
    heat_cls = heat_cls.to(torch.int32)
    target = torch.where((mode == modes.QLC) & (heat_cls == modes.WARM), modes.TLC, mode)
    target = torch.where((mode == modes.QLC) & (heat_cls == modes.HOT), modes.SLC, target)
    target = torch.where((mode == modes.TLC) & (heat_cls == modes.HOT), modes.SLC, target)
    return target.to(torch.int32)
