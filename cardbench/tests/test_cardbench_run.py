"""A whole run of each cell on the CPU at small sizes (the harness's look for
a card skipped): the result line's keys and names; the faults that a cell
can have each turn ``correct`` false; the control comes out not correct."""

import json
import time

import pytest
import torch

from cardbench import harness
from cardbench.reference import transformer as ref
from cardbench.tests.small import small

BENCH = harness.benchmark()
TRAIN, PREFILL = "granite-moe-train-4x2048", "deepseek7b-prefill-lognorm"
SEED = 2 ** 31 + 977  # past 32 signed bits: seeds may be that large
FAULTS = {TRAIN: ["", "half_batch", "state_unchanged"], PREFILL: ["", "token_altered"]}


def run(name, trace=False, fault="", dtype="float32"):
    torch.manual_seed(0)
    return harness.run(small(name, dtype), SEED, 0.2, trace, "cpu", time.perf_counter(),
                       fault=fault)


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs])
def test_faults_turn_correct_false(name, fault):
    out = run(name, fault=fault)
    assert out["correct"] is (fault == ""), out["checks"]


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    out = run(name, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert json.loads(json.dumps(out)) == out
    cell = harness.cell(name)
    group = cell.per_layer if trace else cell.end_to_end
    mine = {m["name"]: m["unit"] for m in group if cell.applies(m)}
    assert set(out["metrics"]) <= set(mine)
    if not trace:
        assert set(out["metrics"]) == set(mine)
    for k, v in out["metrics"].items():
        assert v["unit"] == mine[k] and isinstance(v["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0


def test_train_control_reads_above_the_program():
    """The reference at the control's precision (float8 operands) in the
    program's place reads above the program in bf16. At this size the
    control's gradient gap stays under the cell's limit, which it passes
    only at the cell's own size (``test_cardbench_card.py`` holds that on
    the card)."""
    from cardbench.runners import train

    cell = small(TRAIN, "bfloat16")
    ctx = harness.Context(cell, SEED, torch.device("cpu"), False)
    refr = train.reference(ctx)
    control = train.numbers(train.reference(ctx, ref.FP8), refr)
    st = train.setup(ctx)
    program = train.numbers(train.keep(ctx, st, harness.Window(0, 0.0, {})), refr)
    assert control["grad_leaf_gap"] > 1.5 * program["grad_leaf_gap"], (control, program)


def test_prefill_control_not_correct():
    from cardbench import calibrate
    from cardbench.runners import prefill

    cell = small(PREFILL, "bfloat16")
    ctx = harness.Context(cell, SEED, torch.device("cpu"), False)
    refr = prefill.reference(ctx, all_logits=True, precs=(ref.F32, ref.FP8))
    ok, checks = harness.judge(calibrate.control_prefill(refr), cell.limits["limits"])
    assert not ok, checks
