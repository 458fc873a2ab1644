"""``repro_torch.spans``: off by default and free of effect on the results;
on under torch.profiler (on the CPU here) with every span a host event,
nested as the program nests them; the counts a training step and a
prefill make; ``moe.backward`` around exactly the MoE layer's own
backward nodes; ``moe.kept`` against a direct count of the capacity drop;
the bounded store and an idempotent ``snapshot()``."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.configs import granite_moe_3b_a800m, tinyllama_1_1b
from repro_torch.configs.base import smoke_variant
from repro_torch.models import base, moe, registry
from repro_torch.serving import serve_step
from repro_torch.training import optim
from repro_torch.training import train_step as ts

LAYERS = 2
MOE_PHASES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
TRAIN_NAMES = ("train.step", "train.forward", "train.backward", "train.optimizer")
PREFILL_LAYER = ("prefill.qkv", "prefill.attention", "prefill.out", "prefill.mlp")
PREFILL_NAMES = ("prefill", "prefill.embed", *PREFILL_LAYER, "prefill.head", "prefill.cache")


@pytest.fixture(autouse=True)
def fresh_store():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def moe_cfg(**kw):
    return smoke_variant(granite_moe_3b_a800m.CONFIG).with_(n_layers=LAYERS, **kw)


def dense_cfg():
    return smoke_variant(tinyllama_1_1b.CONFIG).with_(n_layers=LAYERS)


def params_of(cfg, seed=0):
    return base.materialize(registry.get_api(cfg).specs(), torch.Generator().manual_seed(seed),
                            torch.float32)


def batch_of(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g),
            "labels": torch.randint(0, cfg.vocab, (b, s), generator=g)}


def train_once(cfg, params, batch, microbatches=1):
    p = base.tree_map(lambda t: t.clone(), params)
    step = ts.make_train_step(cfg, optim.AdamWConfig(lr=1e-3, warmup=0), microbatches)
    p, o, m = step(p, optim.init(p), batch)
    return base.tree_leaves((p, o.m, o.v)) + [m["loss"], m["grad_norm"]]


def prefill_once(cfg, params, tokens):
    nxt, cache = serve_step.make_prefill(cfg)(params, {"tokens": tokens})
    return [nxt] + [cache[k] for k in sorted(cache)]


def records():
    return [r for u in spans._store.units for r in u.records]


def test_off_by_default_records_nothing():
    assert not spans.on()
    assert spans.span("a") is spans.span("b")  # the one shared null context
    cfg = moe_cfg(remat=True)
    train_once(cfg, params_of(cfg), batch_of(cfg))
    dense = dense_cfg()
    prefill_once(dense, params_of(dense), batch_of(dense)["tokens"])
    spans.count("moe.kept", 3)
    assert spans.snapshot() == [] and records() == []


@pytest.mark.parametrize("path", ["moe_train", "prefill"])
def test_results_bit_equal_with_spans_on_and_off(path):
    cfg = moe_cfg(remat=True) if path == "moe_train" else dense_cfg()
    params, batch = params_of(cfg), batch_of(cfg)

    def go():
        if path == "moe_train":
            return train_once(cfg, params, batch)
        return prefill_once(cfg, params, batch["tokens"])

    off = go()
    spans.enable()
    on = go()
    spans.disable()
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(spans.snapshot()) == 1


def test_profiler_turns_spans_on_and_sees_every_span():
    cfg, dense = moe_cfg(remat=True), dense_cfg()
    params, batch = params_of(cfg), batch_of(cfg)
    dparams = params_of(dense)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        train_once(cfg, params, batch)
        prefill_once(dense, dparams, batch["tokens"])
    assert not spans.on()
    host = {}
    for e in prof.events():
        host.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    every = TRAIN_NAMES + MOE_PHASES + ("moe.backward",) + PREFILL_NAMES
    assert all(name in host for name in every), sorted(set(every) - set(host))

    units = list(spans._store.units)
    assert [u.name for u in units] == ["train.step", "prefill"]
    assert [u.id for u in units] == [0, 1]
    for u in units:
        assert u.records[0].name == u.name and u.records[0].parent is None
        assert all(r.unit is u and r.t1 is not None for r in u.records)
        for r in u.records[1:]:  # a child lies inside its parent on the host clock
            assert r.parent.unit is u and r.parent.t0 <= r.t0 <= r.t1 <= r.parent.t1
    by_name = {}
    for r in units[0].records[1:]:
        by_name.setdefault(r.name, []).append(r)
    parents = {n: [r.parent.name for r in rs] for n, rs in by_name.items()}
    assert parents["train.forward"] == parents["train.optimizer"] == ["train.step"]
    assert parents["moe.backward"] == ["train.backward"] * LAYERS
    for name in MOE_PHASES:  # the forward's, then remat's recompute's, outside moe.backward
        assert parents[name] == ["train.forward"] * LAYERS + ["train.backward"] * LAYERS
    assert all(r.parent.name == "prefill" for r in units[1].records[1:]
               if r.name in ("prefill.embed", "prefill.head", "prefill.cache"))
    # the profiler's ranges nest as the records do
    step, fwd = host["train.step"][0], host["train.forward"][0]
    assert step[0] <= fwd[0] <= fwd[1] <= step[1]
    assert all(step[0] <= a <= b <= step[1] for a, b in host["moe.backward"])


@pytest.mark.parametrize("remat,microbatches", [(True, 1), (False, 1), (True, 2)])
def test_counts_per_training_step(remat, microbatches):
    cfg = moe_cfg(remat=remat)
    spans.enable()
    train_once(cfg, params_of(cfg), batch_of(cfg, b=4), microbatches)
    (unit,) = spans.snapshot()
    counts = {k: v["count"] for k, v in unit["spans"].items()}
    passes = microbatches * (2 if remat else 1)
    assert counts == {"train.step": 1, "train.forward": microbatches,
                      "train.backward": microbatches, "train.optimizer": 1,
                      "moe.backward": LAYERS * microbatches,
                      **{name: LAYERS * passes for name in MOE_PHASES}}
    n_k = 4 * 16 // microbatches * cfg.top_k
    assert unit["counters"]["moe.assigned"] == LAYERS * passes * n_k
    assert 0 < unit["counters"]["moe.kept"] <= unit["counters"]["moe.assigned"]
    for v in unit["spans"].values():
        assert v["stream_s"] is None  # no CUDA events on the CPU
        assert 0.0 <= v["self_s"] <= v["host_s"]


def test_counts_per_prefill_request():
    cfg = dense_cfg()
    params = params_of(cfg)
    spans.enable()
    for s in (8, 24):
        prefill_once(cfg, params, batch_of(cfg, b=1, s=s)["tokens"])
    units = spans.snapshot()
    assert [u["name"] for u in units] == ["prefill", "prefill"]
    for u in units:
        counts = {k: v["count"] for k, v in u["spans"].items()}
        assert sum(counts.values()) == LAYERS * 4 + 4
        assert counts == {"prefill": 1, "prefill.embed": 1, "prefill.head": 1,
                          "prefill.cache": 1, **{name: LAYERS for name in PREFILL_LAYER}}
        assert u["counters"] == {}


def test_moe_backward_holds_exactly_the_layer_nodes():
    """Autograd runs the nodes made between a layer's two markers, and only
    those, inside its ``moe.backward``: by sequence number, on the
    profiler's record of the backward."""
    cfg = moe_cfg(remat=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_once(cfg, params_of(cfg), batch_of(cfg))
    evals = [e for e in prof.events()
             if e.name.startswith("autograd::engine::evaluate_function: ")
             and e.sequence_nr >= 0]
    opens = [e for e in evals if "_OpensInBackward" in e.name]
    closes = [e for e in evals if "_ClosesInBackward" in e.name]
    spans_bw = sorted((e for e in prof.events() if e.name == "moe.backward"),
                      key=lambda e: e.time_range.start)
    assert len(opens) == len(closes) == len(spans_bw) == LAYERS
    for sp in spans_bw:
        a, b = sp.time_range.start, sp.time_range.end
        (hi,) = [e.sequence_nr for e in opens if e.time_range.start <= a <= e.time_range.end]
        (lo,) = [e.sequence_nr for e in closes if a <= e.time_range.start <= b]
        inside = [e for e in evals if a <= e.time_range.start and e.time_range.end <= b]
        between = [e for e in evals if lo < e.sequence_nr < hi]
        assert len(inside) > 10
        assert all(lo < e.sequence_nr < hi for e in inside)
        assert sorted(id(e) for e in between) == sorted(id(e) for e in inside)


class _FloatOps(TorchDispatchMode):
    """Counts the ops that make a floating tensor with elements, views aside."""

    VIEWS = {"view", "_unsafe_view", "alias", "detach", "expand", "select", "slice",
             "t", "transpose", "unsqueeze", "squeeze", "permute", "as_strided"}

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (isinstance(out, torch.Tensor) and out.is_floating_point() and out.numel()
                and name not in self.VIEWS):
            self.ops[(name, tuple(out.shape))] += 1
        return out


def test_spans_leave_the_remat_recompute_as_it_is():
    """The markers and counters add no floating work to a step: the
    recompute stops where it stops without them (checkpoint's early stop)."""
    cfg = moe_cfg(remat=True)
    params, batch = params_of(cfg), batch_of(cfg)
    seen = {}
    for mode in ("off", "on"):
        (spans.enable if mode == "on" else spans.disable)()
        with _FloatOps() as ops:
            train_once(cfg, params, batch)
        seen[mode] = ops.ops
    assert seen["on"] == seen["off"]


def test_moe_kept_counts_the_capacity_drop():
    cfg = moe_cfg(capacity_factor=0.5)
    p = params_of(cfg)["moe_layers"][0]["moe"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(5))
    n = x.shape[0] * x.shape[1]
    _, _, idx = moe._route(x.reshape(n, -1), p["router"], cfg.top_k)
    cap = moe.capacity(cfg, n)
    kept = int((moe._slots(idx, cfg.n_experts, cap) < cfg.n_experts * cap).sum())
    assert kept < n * cfg.top_k  # the case drops
    spans.enable()
    with spans.span("unit"):
        moe.moe_apply(p, x, cfg)
    (unit,) = spans.snapshot()
    assert unit["counters"] == {"moe.kept": kept, "moe.assigned": n * cfg.top_k}


def test_store_keeps_the_newest_units(monkeypatch):
    monkeypatch.setattr(spans, "MAX_UNITS", 3)
    spans.reset()
    spans.enable()
    for i in range(5):
        with spans.span(f"u{i}"):
            with spans.span("inner"):
                spans.count("n", torch.tensor(i))
    units = spans.snapshot()
    assert [u["name"] for u in units] == ["u2", "u3", "u4"]
    assert [u["unit"] for u in units] == [2, 3, 4]
    assert [u["counters"] for u in units] == [{"n": 2}, {"n": 3}, {"n": 4}]
    assert spans.snapshot() == units  # idempotent
    spans.reset()
    assert spans.snapshot() == []


def test_self_time_and_spans_left_open():
    spans.enable()
    with spans.span("outer"):
        with spans.span("child"):
            sum(range(10000))
        spans._open("left.open")  # closed by its parent, at the parent's exit
    (unit,) = spans.snapshot()
    s = unit["spans"]
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["host_s"] - s["child"]["host_s"] - s["left.open"]["host_s"], abs=1e-12)
    assert s["left.open"]["count"] == 1 and spans._store.open == []
    spans.count("after", 1)  # no span open: no unit to count in
    assert spans.snapshot() == [unit]


class _FakeEvent:
    def __init__(self, done, t):
        self.done, self.t = done, t

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_pending_pairs_read_without_waiting_stop_at_the_first_unfinished():
    st = spans._Store()
    recs = [spans._Record(f"r{i}", None, None) for i in range(3)]
    for r, done in zip(recs, (True, False, True)):
        r.events = (_FakeEvent(True, 1.0), _FakeEvent(done, 3.5))
        st.pending.append(r)
    st.read(wait=False)
    assert recs[0].stream_s == pytest.approx(2.5e-3) and recs[1].stream_s is None
    assert len(st.pending) == 2 and len(st.pool) == 2
    st.read(wait=True)
    assert [r.stream_s for r in recs] == [pytest.approx(2.5e-3)] * 3 and not st.pending
