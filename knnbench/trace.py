"""From ``torch.profiler`` traces to the numbers the metrics read.

A traced run traces the device twice, after its window.  First the device
alone over some ticks, with the host's clock around them: from it, the
device's busy seconds (the union of every device interval, kernels, copies
and fills, over all streams) and device seconds by kernel name.  Recording
no host operation, that trace slows the host little, so its idle share is
the program's.  Then a few ticks with the host's operations as well, where
the harness wraps each tick in a ``record_function`` span named
``TICK_SPAN`` and each call into the program in one named
``knnbench.<part>``: from it, the idle gaps between device intervals, each
named by the host work under its midpoint, the harness's span and the
innermost program operation.  Both are read from the raw events
(``kineto_results``), which cost far less than the profiler's own tables.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

TICK_SPAN = "knnbench.tick"
SPAN_PREFIX = "knnbench."
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict  # device seconds by kernel name
    gaps: list  # (name, seconds), longest first

    def device_seconds(self, match) -> float:
        """Device seconds of kernels whose name contains one of ``match``."""
        return sum(s for name, s in self.kernels.items()
                   if any(m in name for m in match))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in self.gaps[:top]]}


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged, sorted intervals of possibly overlapping ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], reach[last]


def _device_intervals(events):
    """(starts, ends, names) of the device's own intervals: the harness's
    spans mirrored on the device's timeline are annotations, not work."""
    from torch.autograd import DeviceType

    s, e, n = [], [], []
    for ev in events:
        if ev.device_type() != DeviceType.CPU and not ev.is_user_annotation():
            s.append(ev.start_ns())
            e.append(ev.start_ns() + ev.duration_ns())
            n.append(ev.name())
    return np.asarray(s, np.int64), np.asarray(e, np.int64), n


def reduce(events, window_s: float, named, top_gaps: int = 10) -> Trace:
    """A :class:`Trace`: busy time and kernels from ``events``, a trace of
    the device alone over ``window_s`` seconds of the host's clock that
    start and end with the device idle; idle gaps from ``named``, a trace
    of the host's operations and the device over whole traced ticks."""
    ds, de, dn = _device_intervals(events)
    kernels = defaultdict(float)
    for name, s, e in zip(dn, ds, de):
        kernels[name] += float(e - s) * 1e-9
    us, ue = _union(ds, de)
    busy_s = float((ue - us).sum()) * 1e-9
    return Trace(window_s=window_s, busy_s=busy_s, kernels=dict(kernels),
                 gaps=_named_gaps(named, top_gaps))


def _named_gaps(events, top_gaps: int):
    """The longest idle gaps of the device inside the traced ticks' spans,
    each named by the host work under its midpoint."""
    from torch.autograd import DeviceType

    cpu_s, cpu_e, cpu_ev = [], [], []
    tick_s, tick_e = [], []
    for ev in events:
        if ev.device_type() != DeviceType.CPU:
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.is_user_annotation() and ev.name() == TICK_SPAN:
            tick_s.append(s)
            tick_e.append(e)
        else:
            cpu_s.append(s)
            cpu_e.append(e)
            cpu_ev.append(ev)
    if not tick_s:
        raise RuntimeError("the trace holds no traced tick")
    w0, w1 = min(tick_s), max(tick_e)
    ds, de, _ = _device_intervals(events)
    keep = (de > w0) & (ds < w1)
    us, ue = _union(np.clip(ds[keep], w0, w1), np.clip(de[keep], w0, w1))
    # idle gaps: between the window's edges and the merged busy intervals
    edges_s = np.concatenate([[w0], ue])
    edges_e = np.concatenate([us, [w1]])
    gap = edges_e - edges_s
    order = np.argsort(-gap, kind="stable")[:top_gaps]
    cs = np.asarray(cpu_s, np.int64)
    ce = np.asarray(cpu_e, np.int64)
    gaps = []
    for g in order:
        if gap[g] <= 0:
            break
        mid = (edges_s[g] + edges_e[g]) // 2
        over = np.nonzero((cs <= mid) & (ce >= mid))[0]
        span = "host"
        inner, inner_len = "python", None
        for i in over:
            name = cpu_ev[i].name()
            if name.startswith(SPAN_PREFIX):
                span = name[len(SPAN_PREFIX):]
            elif inner_len is None or ce[i] - cs[i] < inner_len:
                inner, inner_len = name, ce[i] - cs[i]
        gaps.append((f"{span}: {inner}", float(gap[g]) * 1e-9))
    return gaps
