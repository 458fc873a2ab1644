"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.spans``, through ``cardbench/program_spans.py``): on the CPU
the small cells' traced windows give the host and counter metrics and
leave the stream metrics out; a reader reads nothing where the profile's
units disagree with the window's. On the card (``card``), no device event
carries a span's name and every one of the metrics reads a value."""

import dataclasses
import time

import pytest
import torch

from cardbench import harness, tracing
from cardbench.tests.small import small

TRAIN, PREFILL = "granite-moe-train-4x2048", "deepseek7b-prefill-lognorm"
SEED = 2 ** 31 + 977
READERS = {
    TRAIN: {"forward_ms_per_step.train": "stream", "backward_ms_per_step.train": "stream",
            "optimizer_ms_per_step.train": "stream", "moe_routing_ms_per_step.train": "stream",
            "moe_backward_ms_per_step.train": "stream", "moe_drop_share.train": "counter"},
    PREFILL: {"host_ms_per_request.prefill": "host", "stream_ms_per_request.prefill": "stream"},
}
SPAN_NAMES = {"train.step", "train.forward", "train.backward", "train.optimizer", "moe.route",
              "moe.dispatch", "moe.experts", "moe.combine", "moe.backward", "prefill",
              "prefill.embed", "prefill.qkv", "prefill.attention", "prefill.out",
              "prefill.mlp", "prefill.head", "prefill.cache"}


def traced_reading(name, device, dtype="float32"):
    """A traced window of the small cell on ``device``: the Reading its
    per-layer metrics take."""
    torch.manual_seed(0)
    cell = small(name, dtype)
    ctx = harness.Context(cell, SEED, torch.device(device), True)
    drv = harness.runner(cell.traffic)
    st = drv.setup(ctx)
    win, prof = tracing.traced(lambda: drv.window(ctx, st, 0.2, traced=True), ctx.device)
    return harness.Reading(cell.traffic["runner"], cell.config, cell.traffic, win, prof,
                           tracing.port_kernels())


def test_every_new_metric_is_declared_for_its_cell():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for cell, readers in READERS.items():
        for metric, kind in readers.items():
            m = declared[metric]
            assert m["workloads"] == [cell] and m["better"] == "lower"
            assert m["source"] == ("program_counter" if kind == "counter" else "program_span")


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_small_cells_traced_on_the_cpu(name):
    out = harness.run(small(name), SEED, 0.2, True, "cpu", time.perf_counter())
    for metric, kind in READERS[name].items():
        if kind == "stream":  # no CUDA events on the CPU
            assert metric not in out["metrics"]
        else:
            v = out["metrics"][metric]["value"]
            assert isinstance(v, float) and v >= 0.0, metric
    assert out["correct"]


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_reader_reads_nothing_where_the_units_disagree(name):
    r = traced_reading(name, "cpu")
    readers = {m: harness.metric_reader(m) for m in READERS[name]}
    read = {m: f(r) for m, f in readers.items()}
    assert all(v is not None for m, v in read.items() if READERS[name][m] != "stream")
    for units in (r.window.units - 1, r.window.units + 1):
        other = dataclasses.replace(r, window=dataclasses.replace(r.window, units=units))
        assert all(f(other) is None for f in readers.values())
    no_spans = dataclasses.replace(r, profile=dataclasses.replace(
        r.profile, host=[h for h in r.profile.host if h[2] not in SPAN_NAMES]))
    assert all(f(no_spans) is None for f in readers.values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")


@pytest.mark.card
@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_spans_stay_off_the_device_and_every_metric_reads(card, name):
    r = traced_reading(name, "cuda:0", "bfloat16")
    assert r.profile.kernels
    assert not {n for n, _, _ in r.profile.kernels} & SPAN_NAMES
    assert {h[2] for h in r.profile.host} & SPAN_NAMES
    for metric in READERS[name]:
        v = harness.metric_reader(metric)(r)
        assert isinstance(v, float) and v >= 0.0, (metric, v)
