"""BENCHMARK.json's format and limits, and every piece of every
cell found by name in a file of its own."""

import json
import math
import re
from pathlib import Path

import pytest

from cardbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expansion|expand"
                   r"|experts_per_tok")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    runs = 2 + 14 * 24  # the full 24 cells later PRs may reach
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and (group, e["name"]) not in names
            names.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert one_line(e[k])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("cardbench/configs/")
    c = json.loads(path.read_text())
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in c and key in c["published"]
        assert not WIDTH.search(key), f"{key} is a width"
    assert sum(1 for w in BENCH["workloads"] if w["config"] == cfg["name"]) >= 1
    harness.port_config(c)  # the program can run it as written


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_pieces_found_by_name(name):
    cell = harness.cell(name)
    w = cell.workload
    assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert (ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert (ROOT / "cardbench" / "runners" / f"{cell.traffic['runner']}.py").is_file()
    harness.runner(cell.traffic)
    e2e = [m["name"] for m in cell.end_to_end if cell.applies(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in cell.per_layer if cell.applies(m)]
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
    assert set(cell.limits["limits"]) and all(v >= 0 for v in cell.limits["limits"].values())


def test_chips_and_metric_cells():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    layer_names = {m["layer"] for m in BENCH["per_layer"]}
    assert all(one_line(x) for x in layer_names)
