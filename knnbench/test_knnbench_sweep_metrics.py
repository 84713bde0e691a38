"""The readers of the sweep's occupancy and scan (``live_row_pct``,
``tail_passes``, ``cand_per_row_pass``, ``scan_device_ms``) on a fabricated
run: each counter's change over a tick as the harness keeps it, from a
fabricated program's tracing totals; their arithmetic; nothing untraced; and
nothing from a program that neither counts the tail passes nor times the scan
on the device."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from knnbench.harness import Run

METRICS = Path(__file__).resolve().parent / "metrics"
NEW = ("live_row_pct", "tail_passes", "cand_per_row_pass", "scan_device_ms")
ROWS = 1000
# per tick: live rows summed over the passes, passes, tail passes, the scan's
# device ms, candidate slots
TICKS = [(2600, 4, 1, 3.0, 150_000.0), (3400, 6, 3, 5.0, 170_000.0)]


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"s_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tracing:
    """A program's tracing module: totals that grow tick by tick."""

    def __init__(self, tail: bool, timed: bool):
        self.on, self.tail, self.timed = False, tail, timed
        self.counters, self.scan = {}, SimpleNamespace(device_ms=None)

    def enable(self):
        self.on = True

    def enabled(self):
        return self.on

    def totals(self):
        return SimpleNamespace(counters=self.counters,
                               spans={"sweep.scan": self.scan})

    def tick(self, rows, passes, tail, scan_ms):
        c = self.counters
        c["sweep.rows"] = c.get("sweep.rows", 0) + rows
        c["sweep.passes"] = c.get("sweep.passes", 0) + passes
        if self.tail:
            c["sweep.tail_passes"] = c.get("sweep.tail_passes", 0) + tail
        if self.timed:
            self.scan.device_ms = (self.scan.device_ms or 0.0) + scan_ms


def _run(monkeypatch, traced=True, tail=True, timed=True):
    """The harness's use of the readers over the two ticks of ``TICKS``."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--trace", str(int(traced))])
    program = _Tracing(tail, timed)

    def port(name):
        if name != "tracing":
            raise ImportError(name)
        return program

    readers = {name: _reader(name) for name in NEW}
    ticks = []
    for rows, passes, n_tail, scan_ms, cand in TICKS:
        before = {n: r.counter(port) for n, r in readers.items()}
        if program.on:
            program.tick(rows, passes, n_tail, scan_ms)
        ticks.append({"rows": ROWS, "candidates": cand,
                      "counters": {n: r.counter(port) - before[n]
                                   for n, r in readers.items()}})
    run = Run(n_objects=ROWS, k=32, setup_s=1.0, window_s=1.0,
              memory_peak_bytes=0, ticks=ticks)
    return {n: r.read(run) for n, r in readers.items()}


def test_the_readers_arithmetic(monkeypatch):
    got = _run(monkeypatch)
    assert got["live_row_pct"] == pytest.approx(
        100.0 * (2600 + 3400) / ((4 + 6) * ROWS))
    assert got["tail_passes"] == pytest.approx(2.0)
    assert got["cand_per_row_pass"] == pytest.approx(320_000 / 6000)
    assert got["scan_device_ms"] == pytest.approx(4.0)


def test_untraced_the_readers_report_nothing(monkeypatch):
    assert _run(monkeypatch, traced=False) == dict.fromkeys(NEW)


def test_a_program_without_the_tail_counter_or_timed_scan(monkeypatch):
    """The program before the sweep counted its tail passes and timed its
    scan on the device: both report nothing, not 0; the occupancy and the
    candidates a row-pass, read from older counters, are there."""
    got = _run(monkeypatch, tail=False, timed=False)
    assert got["tail_passes"] is None and got["scan_device_ms"] is None
    assert got["live_row_pct"] == pytest.approx(60.0)
    assert got["cand_per_row_pass"] == pytest.approx(320_000 / 6000)


def test_a_program_without_tracing_reports_nothing(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--trace", "1"])

    def port(name):
        raise ImportError(name)

    for name in NEW:
        reader = _reader(name)
        before = reader.counter(port)
        ticks = [{"rows": ROWS, "candidates": 1.0,
                  "counters": {name: reader.counter(port) - before}}]
        run = Run(n_objects=ROWS, k=32, setup_s=1.0, window_s=1.0,
                  memory_peak_bytes=0, ticks=ticks)
        assert reader.read(run) is None, name
