"""The ``nav_launches`` reader on the CPU at a tiny size: a traced run
reports the program's counter ``sweep.nav_launches`` (counted here as the
card would count it, since the CPU runs the navigation's plain version and
launches nothing); a program without the kernel's wrapper reports nothing
and the run ends as before."""
from __future__ import annotations

import sys


def _argv(monkeypatch, trace):
    monkeypatch.setattr(sys, "argv", [
        "knnbench/run.py", "--workload", "tiny_uniform.move_all", "--seed",
        "7", "--seconds", "1", "--trace", str(trace)])


def test_traced_run_reports_nav_launches(run_tiny, monkeypatch):
    """One launch a pass that navigates: at least one a tick, at most the
    sweep's passes."""
    from repro_torch import tracing
    from repro_torch.core import pipeline

    real = pipeline.nav_walk

    def counting(*args):
        tracing.count("sweep.nav_launches")
        return real(*args)

    monkeypatch.setattr(pipeline, "nav_walk", counting)
    _argv(monkeypatch, 1)
    try:
        rc, res, err = run_tiny(trace=True)
    finally:
        tracing.disable()
    assert rc == 0, err
    assert res["correct"] is True
    m = {name: v["value"] for name, v in res["metrics"].items()}
    assert res["metrics"]["nav_launches"]["unit"] == "launches/tick"
    assert 1 <= m["nav_launches"] <= m["sweep_passes"]


def test_untraced_run_reports_no_nav_launches(run_tiny, monkeypatch):
    _argv(monkeypatch, 0)
    rc, res, err = run_tiny()
    assert rc == 0, err
    assert "nav_launches" not in res["metrics"]


def test_program_without_the_kernel_reports_no_nav_launches(run_tiny,
                                                            monkeypatch):
    """An older checkout, whose sweep has no navigation kernel: the reader
    reads nothing, the other metrics are there, the run ends cleanly."""
    from repro_torch import tracing

    monkeypatch.setitem(sys.modules, "repro_torch.kernels.nav_walk", None)
    _argv(monkeypatch, 1)
    try:
        rc, res, err = run_tiny(trace=True)
    finally:
        tracing.disable()
    assert rc == 0, err
    assert res["correct"] is True
    assert "nav_launches" not in res["metrics"]
    assert {"sweep_passes", "host_syncs", "b1_launches"} <= set(res["metrics"])
