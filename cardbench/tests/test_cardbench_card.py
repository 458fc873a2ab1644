"""On the card: each cell's command runs end to end, a short window, and
comes out correct. Skipped where there is no CUDA card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", name,
                          "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.card
def test_train_control_not_correct_at_cell_size(card):
    """The control (the reference with float8 operands in the program's
    place) at the training cell's own size fails the cell's limits."""
    import torch

    from cardbench import harness
    from cardbench.runners import train
    from cardbench.reference import transformer as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.cell("granite-moe-train-4x2048")
    ctx = harness.Context(cell, 2 ** 31 + 7, torch.device("cuda:0"), False)
    refr = train.reference(ctx)
    ok, checks = harness.judge(train.numbers(train.reference(ctx, ref.FP8), refr),
                               cell.limits["limits"])
    assert not ok, checks
