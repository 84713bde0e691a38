"""The program's spans and counters in the benchmark (``spans.py`` and its
seven readers), on the CPU at a tiny size: a ``--trace 1`` run turns the
program's tracing on and reports them; a ``--trace 0`` run leaves it off; a
program without tracing reports none of them and does not fail."""
from __future__ import annotations

import sys

import pytest

from knnbench import spans

NEW = ("stage_ms", "refresh_ms", "qsort_ms", "sweep_ms", "sweep_dispatch_ms",
       "sweep_passes", "host_syncs")


@pytest.fixture
def tracing_module():
    """The program's tracing, off again after the test."""
    from repro_torch import tracing

    yield tracing
    tracing.disable()


def _argv(monkeypatch, trace):
    monkeypatch.setattr(sys, "argv", [
        "knnbench/run.py", "--workload", "tiny_uniform.move_all", "--seed",
        "7", "--seconds", "1", "--trace", str(trace)])


@pytest.mark.parametrize("argv,traced", [
    (["--trace", "1"], True), (["--trace=1"], True),
    (["--trace", "0"], False), (["--seed", "1"], False),
    (["--seed", "--trace"], False), ([], False)])
def test_traced_run_read_from_the_command_line(argv, traced):
    assert spans.traced_run(["--workload", "x"] + argv) is traced


def test_traced_run_reports_the_program_spans(run_tiny, monkeypatch,
                                              tracing_module):
    """The seven metrics, non-null; the sweep's passes equal B1's launches
    (counted here as the card would: the CPU runs B1's plain version)."""
    from repro_torch.kernels import fused_scan as tfs

    real = tfs.fused_scan_merge

    def counting(*args, **kw):
        counting.launches += 1
        return real(*args, **kw)

    counting.launches, counting.mixed_launches = 0, 0
    monkeypatch.setattr(tfs, "fused_scan_merge", counting)
    _argv(monkeypatch, 1)
    rc, res, err = run_tiny(trace=True)
    assert rc == 0, err
    assert res["correct"] is True
    m = {name: v["value"] for name, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert all(m[name] > 0 for name in NEW)
    assert res["metrics"]["sweep_passes"]["unit"] == "passes/tick"
    assert abs(m["sweep_passes"] - m["b1_launches"]) < 0.5
    assert m["host_syncs"] >= 2 * m["sweep_passes"]
    ticks = res["window"]["tick_ms"]
    assert m["refresh_ms"] + m["qsort_ms"] + m["sweep_ms"] < sum(ticks) / len(
        ticks)
    assert m["sweep_dispatch_ms"] < m["sweep_ms"]
    assert tracing_module.enabled()


def test_untraced_run_leaves_tracing_off(run_tiny, monkeypatch,
                                         tracing_module):
    _argv(monkeypatch, 0)
    rc, res, err = run_tiny()
    assert rc == 0, err
    assert not set(NEW) & set(res["metrics"])
    assert not tracing_module.enabled()
    assert spans.program() is None


def test_traced_run_without_the_program_tracing_reports_none(
        run_tiny, monkeypatch, tracing_module):
    """A program without a tracing module (an older checkout): the counters
    read zero, the readers nothing, and the run ends as before."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    _argv(monkeypatch, 1)
    rc, res, err = run_tiny("tiny_uniform.tiny_churn", trace=True)
    assert rc == 0, err
    assert res["correct"] is True
    assert not set(NEW) & set(res["metrics"])
    assert {"submit_ms", "sweep_trips", "b1_launches"} <= set(res["metrics"])
    assert not tracing_module.enabled()
