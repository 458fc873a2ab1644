"""The four examples on the port (examples/torch_{quickstart,sweep_experiments,
serve_tiered,train_lm}.py), each run through its ``main`` on the CPU at the
smallest counts that still show what it is for:

- quickstart's printed rows equal the JAX quickstart's at the same request
  count, character for character (its one JAX run);
- the verify flow ``torch_sweep_experiments.py --scenario
  read_disturb_hammer`` has RARO's read p99 and mean beat Baseline's at both
  wear stages;
- the serving example decodes with RARO and the static int4 baseline, and
  the training example trains, checkpoints and lowers its loss;
- every example runs on CUDA unless ``--device`` names another device (with
  no card it raises, never falling back to the CPU), and none imports the
  JAX package.
"""

import importlib.util
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_sweep_experiments", "torch_serve_tiered", "torch_train_lm")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_rows_equal_reference(capsys, monkeypatch):
    _load("torch_quickstart").main(["--requests", "2048", "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--requests", "2048"])
    _load("quickstart").main()  # the JAX package's
    ref = capsys.readouterr().out
    rows = [ln for ln in ref.splitlines() if "IOPS=" in ln]
    assert len(rows) == 3 and "migrated pages=0" in rows[0]
    assert port == ref


def test_sweep_read_disturb_hammer_raro_beats_baseline(capsys):
    res = _load("torch_sweep_experiments").main(
        ["--scenario", "read_disturb_hammer", "--requests", "6000", "--seeds", "1",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "read_disturb_hammer_raro_pe833_seed0" in out
    by = {(r["run"]["policy"], r["run"]["initial_pe"]): r for r in res}
    for pe in (166, 833):
        raro, base = by[("raro", pe)], by[("baseline", pe)]
        assert raro["read_lat_p99_us"] < base["read_lat_p99_us"], pe
        assert raro["mean_read_latency_us"] < base["mean_read_latency_us"], pe


def test_sweep_list_and_artifacts(capsys, tmp_path):
    mod = _load("torch_sweep_experiments")
    assert mod.main(["--list"]) is None
    assert "read_disturb_hammer" in capsys.readouterr().out
    res = mod.main(["--scenario", "zipf", "--requests", "1024", "--seeds", "1",
                    "--device", "cpu", "--out", str(tmp_path)])
    assert len(res) == 6 and len(list(tmp_path.glob("*.json"))) == 6


def test_serve_tiered(capsys):
    out = _load("torch_serve_tiered").main(["--steps", "16", "--batch", "2", "--device", "cpu"])
    assert "static int4-only baseline" in capsys.readouterr().out
    raro, static = out[True], out[False]
    for r in (raro, static):
        assert np.isfinite(r["mean_prob_drift"]) and r["kv_bytes"] > 0
    # the static baseline commits every page at int4 (the QLC analogue)
    assert static["tier_pages"][0] == static["tier_pages"][1] == 0
    assert static["tier_pages"][2] > 0
    assert sum(raro["tier_pages"]) == sum(static["tier_pages"])


def test_train_lm(capsys, tmp_path):
    hist = _load("torch_train_lm").main(["--steps", "30", "--batch", "4", "--seq", "32",
                                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert f"(ln(vocab) = {math.log(512):.3f})" in capsys.readouterr().out
    losses = [loss for _, loss in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert any(tmp_path.iterdir())  # the final checkpoint


@pytest.mark.parametrize("name", NAMES)
def test_no_device_means_cuda(name, monkeypatch):
    """Without --device an example asks for the card, and with none it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"torch_quickstart": ["--requests", "16"], "torch_sweep_experiments": ["--requests", "16"],
            "torch_serve_tiered": ["--steps", "1", "--batch", "1"],
            "torch_train_lm": ["--steps", "1"]}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(args)


@pytest.mark.parametrize("name", NAMES)
def test_imports_nothing_of_the_reference(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    imports = [ln for ln in src.splitlines() if re.match(r"\s*(import|from)\s", ln)]
    assert imports
    for ln in imports:
        assert not re.search(r"\b(jax|repro)\b(?!_torch)", ln), ln
