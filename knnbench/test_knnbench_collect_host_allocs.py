"""The reader ``collect_host_allocs`` on a fabricated run: the change of the
program's counter ``collect.host_allocs`` over each tick as the harness keeps
it, its mean; nothing untraced, nothing from a program without tracing, and
nothing from a program that copies into pageable memory (no
``collect.pinned``), where 0 would read as a pinned copy that allocates
nothing."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from knnbench.harness import Run

METRICS = Path(__file__).resolve().parent / "metrics"
NAME = "collect_host_allocs"
ROWS = 1000
# per tick: the pinned blocks the copy made, the tensors it pinned
TICKS = [(4, 4), (4, 4), (0, 4), (0, 4), (0, 4)]


def _reader():
    spec = importlib.util.spec_from_file_location(f"c_{NAME}",
                                                  METRICS / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tracing:
    """A program's tracing module: totals that grow tick by tick."""

    def __init__(self, pinned: bool):
        self.on, self.pinned, self.counters = False, pinned, {}

    def enable(self):
        self.on = True

    def enabled(self):
        return self.on

    def totals(self):
        return SimpleNamespace(counters=self.counters, spans={})

    def tick(self, made, pinned):
        c = self.counters
        c["host.syncs"] = c.get("host.syncs", 0) + 2
        if self.pinned:
            c["collect.host_allocs"] = c.get("collect.host_allocs", 0) + made
            c["collect.pinned"] = c.get("collect.pinned", 0) + pinned


def _read(monkeypatch, ticks=TICKS, traced=True, pinned=True, tracing=True):
    """The harness's use of the reader over ``ticks``."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--trace", str(int(traced))])
    program = _Tracing(pinned)

    def port(name):
        if name != "tracing" or not tracing:
            raise ImportError(name)
        return program

    reader = _reader()
    rows = []
    for made, n in ticks:
        before = reader.counter(port)
        if program.on:
            program.tick(made, n)
        rows.append({"rows": ROWS, "candidates": 1.0,
                     "counters": {NAME: reader.counter(port) - before}})
    run = Run(n_objects=ROWS, k=32, setup_s=1.0, window_s=1.0,
              memory_peak_bytes=0, ticks=rows)
    return reader.read(run)


@pytest.mark.parametrize("ticks,want", [
    (TICKS, 8 / 5),
    (TICKS[2:], 0.0),  # every block reused: 0, not nothing
])
def test_the_mean_of_the_blocks_made_a_tick(monkeypatch, ticks, want):
    assert _read(monkeypatch, ticks) == pytest.approx(want)


@pytest.mark.parametrize("case", [
    {"traced": False},
    {"pinned": False},  # a pageable copy
    {"tracing": False},  # a program without a tracing module
])
def test_the_reader_reports_nothing(monkeypatch, case):
    assert _read(monkeypatch, **case) is None
