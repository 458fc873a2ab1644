"""Spans and counters of the port's hot paths: the training step's phases
(``training/train_step.py``), the MoE layer's phases and capacity drops
(``models/moe.py::moe_apply``) and the dense prefill's layers
(``serving/serve_step.py::make_prefill``, ``models/transformer.py::prefill``).

Off by default: ``span(name)`` then costs one check and returns a shared
null context. Spans are on while a torch profiler runs, and after
``enable()`` (``disable()`` turns that off again). When on, a span

1. opens a profiler range named ``name`` if a profiler runs, at FUNCTION
   scope (``_RecordFunctionFast``), so that it lies on the profiler's host
   timeline and projects nothing onto the device's;
2. takes ``time.perf_counter_ns()`` at entry and exit;
3. where CUDA is up, records a timing event at entry and at exit on the
   current stream (from a reused pool), whose interval is the span's
   stream time: from the stream reaching the opening marker to reaching
   the closing one.

A span opened while none is open starts a unit (one a ``train.step`` or
``prefill`` call); everything opened inside it, and the counters added
meanwhile (``count``), belong to that unit. The store keeps the newest
``MAX_UNITS`` units in memory. Event pairs are read without blocking
(``Event.query``) once more than ``PENDING_CAP`` wait, never by a
synchronize inside a step; ``snapshot()`` makes one synchronize and returns
each unit's totals by span name.

Spans open and close from one thread at a time: the caller's, or
autograd's device thread while the caller waits in a backward
(``backward_span``), whose spans take the caller's open span as parent.

Names and what opens them:

- ``train.step`` (a unit), ``train.forward`` (the loss), ``train.backward``
  (``torch.autograd.grad``, remat's recompute inside it),
  ``train.optimizer`` (``optim.update``); forward and backward once a
  microbatch;
- ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` (in the
  forward and in remat's recompute), ``moe.backward`` (the layer's own
  backward); counters ``moe.kept`` (assignments kept after the capacity
  drop) and ``moe.assigned`` (N·K);
- ``prefill`` (a unit, the argmax included), ``prefill.embed``, per layer
  ``prefill.qkv``, ``prefill.attention``, ``prefill.out``, ``prefill.mlp``,
  then ``prefill.head`` and ``prefill.cache``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

MAX_UNITS = 256  # units the store keeps, the newest
# event pairs left unread before closing a span reads the finished ones: above
# a traced window's (~4,000 spans a prefill cycle), whose spans then read no
# event inside it (a pair's query and elapsed time cost ~10 us on the host)
PENDING_CAP = 8192

_switch = False
_NULL = contextlib.nullcontext()


def enable():
    """Turn spans on (they are on anyway while a torch profiler runs)."""
    global _switch
    _switch = True


def disable():
    global _switch
    _switch = False


def on() -> bool:
    """Whether spans record: after ``enable()`` or while a profiler runs."""
    return _switch or _profiler._is_profiler_enabled


class _Unit:
    __slots__ = ("id", "name", "records", "counters")

    def __init__(self, uid: int, name: str):
        self.id, self.name, self.records, self.counters = uid, name, [], {}


class _Record:
    __slots__ = ("name", "parent", "unit", "t0", "t1", "events", "stream_s", "range")

    def __init__(self, name: str, parent, unit: _Unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0 = self.t1 = self.events = self.stream_s = self.range = None


class _Store:
    def __init__(self):
        self.units: collections.deque = collections.deque(maxlen=MAX_UNITS)
        self.open: list = []  # open records, innermost last
        self.pending: collections.deque = collections.deque()  # closed, events not yet read
        self.pool: list = []  # timing events free for reuse
        self.streams: dict = {}  # (stream id, device, type) -> its torch.cuda.Stream
        self.ids = itertools.count()

    def event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)

    def record(self, ev):
        """Record ``ev`` on the current stream. ``Event.record()`` builds a
        ``torch.cuda.Stream`` for it each time, more than half of a record's
        cost on the host; here each stream's handle is built once."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                           device_type=key[2])
        ev.record(stream)

    def read(self, wait: bool):
        """Read the pending records' stream times, oldest first; without
        ``wait`` stop at the first pair the device has not reached."""
        while self.pending:
            rec = self.pending[0]
            start, end = rec.events
            if not wait and not (end.query() and start.query()):
                return
            rec.stream_s = start.elapsed_time(end) / 1e3
            rec.events = None
            self.pool += (start, end)
            self.pending.popleft()


_store = _Store()


def _open(name: str) -> _Record:
    s = _store
    parent = s.open[-1] if s.open else None
    if parent is None:
        unit = _Unit(next(s.ids), name)
        s.units.append(unit)
    else:
        unit = parent.unit
    rec = _Record(name, parent, unit)
    unit.records.append(rec)
    if _profiler._is_profiler_enabled:
        rec.range = _RecordFunctionFast(name)
        rec.range.__enter__()
    if torch.cuda.is_initialized():
        rec.events = (s.event(), s.event())
        s.record(rec.events[0])
    s.open.append(rec)
    rec.t0 = time.perf_counter_ns()
    return rec


def _close(rec: _Record):
    """Close ``rec`` and any span still open inside it."""
    s = _store
    if rec not in s.open:  # closed already, by an enclosing span or ``reset``
        return
    t1 = time.perf_counter_ns()
    while True:
        top = s.open.pop()
        top.t1 = t1
        if top.events is not None:
            s.record(top.events[1])
            s.pending.append(top)
        if top.range is not None:
            top.range.__exit__(None, None, None)
        if top is rec:
            break
    if len(s.pending) > PENDING_CAP:
        s.read(wait=False)


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _open(self.name)
        return self

    def __exit__(self, *exc):
        _close(self.rec)
        return False


def span(name: str):
    """A context manager over a piece of work; the shared null context when
    spans are off."""
    if not (_switch or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, value):
    """Add ``value`` (an int, or a device tensor, added on the device) to the
    current unit's counter ``name``; nothing when spans are off or no span is
    open."""
    if (_switch or _profiler._is_profiler_enabled) and _store.open:
        c = _store.open[-1].unit.counters
        c[name] = c.get(name, 0) + value


class _ClosesInBackward(torch.autograd.Function):
    """Identity on a layer's input; its backward closes the layer's backward
    span. It keeps an empty tensor, packed before the layer's own, for the
    output marker to unpack (below)."""

    @staticmethod
    def forward(ctx, x, opener, records):
        ctx.records = records
        ctx.save_for_backward(x.new_empty(0))
        opener.append(ctx)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.records:
            _close(ctx.records.pop())
        return g, None, None


class _OpensInBackward(torch.autograd.Function):
    """Identity on a layer's output; its backward opens the layer's backward
    span. First it unpacks the input marker's empty tensor: inside a remat
    checkpoint that runs the layer's recompute, so the recompute comes before
    the span and the span holds the layer's own backward. The tensor was
    packed ahead of the layer's, so the recompute stops where it would
    without the markers."""

    @staticmethod
    def forward(ctx, y, opener, records, name):
        ctx.opener, ctx.records, ctx.name = opener, records, name
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        _ = ctx.opener[0].saved_tensors  # the recompute, where there is one
        ctx.records.append(_open(ctx.name))
        return g, None, None, None


def _same(y):
    return y


def backward_span(name: str, x):
    """A span ``name`` over the backward of a layer: returns ``(x, mark)``,
    ``x`` to be the layer's input and ``mark(y)`` to be applied to its
    output. The backward of the output marker opens the span, that of the
    input marker closes it; between them autograd runs the nodes made
    between the two markers (by sequence number, higher first). The span's
    parent is the span open when it opens (``train.backward`` in a step),
    whatever thread autograd runs it on. Where spans are off, or ``x``
    needs no gradient: ``(x, identity)``, and no marker is made. Under
    remat the recompute must make the markers the forward made: turn spans
    on or off between steps, not between a layer's forward and backward."""
    if not (on() and torch.is_grad_enabled() and x.requires_grad):
        return x, _same
    opener: list = []  # the input marker's node, for the output marker (no cycle through it)
    records: list = []  # the open span, from the output marker's backward to the input's
    x = _ClosesInBackward.apply(x, opener, records)
    return x, lambda y: _OpensInBackward.apply(y, opener, records, name)


def snapshot() -> list:
    """One synchronize, then per unit in order: ``{"unit", "name", "spans",
    "counters"}``, where ``spans`` maps each span name to its ``count`` and
    its seconds summed over the unit's closed spans of that name: ``host_s``
    (entry to exit), ``self_s`` (``host_s`` less its child spans'), and
    ``stream_s`` (None where a span took no CUDA events); ``counters`` maps
    each counter to an int."""
    s = _store
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    s.read(wait=True)
    out = []
    for u in s.units:
        closed = [r for r in u.records if r.t1 is not None]
        child_ns: dict = {}
        for r in closed:
            if r.parent is not None:
                child_ns[id(r.parent)] = child_ns.get(id(r.parent), 0) + r.t1 - r.t0
        by_name: dict = {}
        for r in closed:
            e = by_name.setdefault(r.name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                            "stream_s": 0.0})
            host = (r.t1 - r.t0) / 1e9
            e["count"] += 1
            e["host_s"] += host
            e["self_s"] += host - child_ns.get(id(r), 0) / 1e9
            e["stream_s"] = (None if e["stream_s"] is None or r.stream_s is None
                             else e["stream_s"] + r.stream_s)
        for k, v in u.counters.items():
            if isinstance(v, torch.Tensor):
                u.counters[k] = int(v)
        out.append({"unit": u.id, "name": u.name, "spans": by_name,
                    "counters": dict(u.counters)})
    return out


def reset():
    """Empty the store: units, open spans and unread event pairs."""
    global _store
    _store = _Store()
