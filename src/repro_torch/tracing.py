"""Spans and counters inside a tick, off by default.

One switch for the process: :func:`enable`, :func:`disable`, :func:`enabled`.
Off, :func:`span` hands back one shared no-op context and :func:`count`
returns, each after a single check of the switch: no record, no profiler
range, no CUDA event and no clock reading.

On, a span records its name, its parent (the innermost span open in the same
tick) and its start and end on ``time.perf_counter_ns()``, and enters
``torch.profiler.record_function("repro_torch.<name>")``, so a running
profiler stamps it on the clock of the device's kernels and copies.  A span
opened with ``device=True`` on a CUDA tick also records a pair of timing
events on the current stream, taken from a pool; their elapsed time, the
span's extent on the device, is read when the tick's result is collected,
after its work has drained.  On the CPU, where the work runs inside the call,
the device extent is the host duration.

Every span and count lands in the record of one tick: the hand-in calls'
go to the next submitted tick (:func:`open_tick` adopts them), ``submit()``'s
to the tick it creates, and ``result()``'s and the tick's finalize to that
handle's tick (:func:`into`).  A record is kept aggregated per span name;
:func:`finish` resolves its device times and hands it out as a
:class:`TickTrace` (``TickResult.trace``), and adds it to :func:`totals`.
Nothing is written anywhere during a tick.
"""
from __future__ import annotations

import dataclasses
import time

import torch

__all__ = [
    "SpanStats",
    "TickTrace",
    "count",
    "disable",
    "enable",
    "enabled",
    "finish",
    "into",
    "open_tick",
    "span",
    "totals",
]

PREFIX = "repro_torch."


@dataclasses.dataclass
class SpanStats:
    """One span name's sum over a tick (or over :func:`totals`' ticks).

    ``self_ms`` is ``host_ms`` less the part of it that the name's child
    spans cover; ``device_ms`` is None for spans not timed on the device.
    ``parent`` is the name of the span the first one was opened under.
    """

    n: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    device_ms: float | None = None
    parent: str | None = None

    def add(self, other: "SpanStats"):
        self.n += other.n
        self.host_ms += other.host_ms
        self.self_ms += other.self_ms
        if other.device_ms is not None:
            self.device_ms = (self.device_ms or 0.0) + other.device_ms


@dataclasses.dataclass
class TickTrace:
    """A tick's spans, by name, and its counters.

    ``tick`` is the identifier every span of the tick shares, numbered in
    submit order over the process; in :func:`totals` it counts the ticks
    summed.
    """

    tick: int
    spans: dict[str, SpanStats] = dataclasses.field(default_factory=dict)
    counters: dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, other: "TickTrace"):
        for name, st in other.spans.items():
            mine = self.spans.setdefault(name, SpanStats(parent=st.parent))
            mine.add(st)
        for name, n in other.counters.items():
            self.counters[name] = self.counters.get(name, 0) + n


class _Record:
    """A tick's trace while it is being recorded: the open spans and the
    device spans whose events are not read yet."""

    __slots__ = ("trace", "stack", "timed", "cuda")

    def __init__(self, tick: int, cuda: bool = False):
        self.trace = TickTrace(tick)
        self.stack: list[_Span] = []
        self.timed: list[tuple[str, tuple]] = []
        self.cuda = cuda


class _NoSpan:
    """The shared no-op context of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
# a tick submitted while tracing was off has no record: its later spans drop
_NOWHERE = _Record(-1)

_on = False
_current: _Record | None = None  # where spans go; None: the hand-in record
_handin: _Record | None = None  # spans made outside any tick
_next_tick = 0
_pool: list[tuple] = []  # idle pairs of CUDA timing events
_totals = TickTrace(0)


def enable():
    """Turn tracing on for the process; the totals start again from zero."""
    global _on, _current, _handin, _totals
    if not _on:
        _current = _handin = None
        _totals = TickTrace(0)
        _on = True


def disable():
    """Turn tracing off; records not finished yet are dropped."""
    global _on, _current, _handin
    _on = False
    _current = _handin = None


def enabled() -> bool:
    return _on


def _target() -> _Record:
    global _handin
    if _current is not None:
        return _current
    if _handin is None:
        _handin = _Record(-1)
    return _handin


class _Span:
    __slots__ = ("name", "device", "rec", "parent", "child_ns", "events",
                 "range", "t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        rec = self.rec = _target()
        if rec is _NOWHERE:
            return self
        self.parent = rec.stack[-1].name if rec.stack else None
        self.child_ns = 0
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.events = None
        if self.device and rec.cuda:
            self.events = (_pool.pop() if _pool else
                           (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)))
            self.events[0].record()
        rec.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is _NOWHERE:
            return False
        if self.events is not None:
            self.events[1].record()
            rec.timed.append((self.name, self.events))
        rec.stack.pop()
        self.range.__exit__(*exc)
        dur = t1 - self.t0
        if rec.stack:
            rec.stack[-1].child_ns += dur
        st = rec.trace.spans.get(self.name)
        if st is None:
            st = rec.trace.spans[self.name] = SpanStats(parent=self.parent)
        st.n += 1
        st.host_ms += dur * 1e-6
        st.self_ms += (dur - self.child_ns) * 1e-6
        if self.device and not rec.cuda:
            st.device_ms = (st.device_ms or 0.0) + dur * 1e-6
        return False


def span(name: str, device: bool = False):
    """A context that records one span named ``name`` (tracing on), else the
    shared no-op context."""
    if not _on:
        return _NOOP
    return _Span(name, device)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the tick being recorded."""
    if not _on:
        return
    rec = _target()
    if rec is not _NOWHERE:
        rec.trace.counters[name] = rec.trace.counters.get(name, 0) + n


def open_tick(device: torch.device) -> _Record | None:
    """The record of a tick being submitted on ``device``, holding what was
    recorded outside any tick since the last one; None with tracing off."""
    global _handin, _next_tick
    if not _on:
        return None
    rec = _Record(_next_tick, cuda=torch.device(device).type == "cuda")
    _next_tick += 1
    if _handin is not None:
        rec.trace.add(_handin.trace)
        _handin = None
    return rec


class _Into:
    __slots__ = ("rec", "prev")

    def __init__(self, rec: _Record):
        self.rec = rec

    def __enter__(self):
        global _current
        self.prev, _current = _current, self.rec
        return self

    def __exit__(self, *exc):
        global _current
        _current = self.prev
        return False


def into(rec: _Record | None):
    """A context in which spans and counts go to ``rec``, a record from
    :func:`open_tick` (None: the tick has none, and they are dropped)."""
    if rec is None and not _on:
        return _NOOP
    return _Into(_NOWHERE if rec is None else rec)


def finish(rec: _Record | None) -> TickTrace | None:
    """The tick's :class:`TickTrace`, its device times read; added to the
    totals.  Call it once the tick's work has drained: the events then wait
    on nothing (a tick that copies nothing back is drained here)."""
    if rec is None or rec is _NOWHERE:
        return None
    if rec.timed:
        # one stream: once the last event is done, every earlier one is
        rec.timed[-1][1][1].synchronize()
        for name, (start, end) in rec.timed:
            st = rec.trace.spans[name]
            st.device_ms = (st.device_ms or 0.0) + start.elapsed_time(end)
            _pool.append((start, end))
        rec.timed.clear()
    if _on:
        _totals.add(rec.trace)
        _totals.tick += 1
    return rec.trace


def totals() -> TickTrace:
    """The sum of every tick finished since :func:`enable`; its ``tick``
    counts them."""
    return _totals
