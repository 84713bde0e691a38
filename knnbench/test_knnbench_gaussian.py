"""The skewed deployment ``gaussian_1m`` and its cell: the configuration
against its sources and against ``uniform_1m``, and a tiny gaussian cell, cut
so that the leaves at ``l_max`` stay overfull, run through the whole harness
on the CPU correct against ``knn_exact``, traced and untraced."""
from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CONF = json.loads((BENCH / "configs" / "gaussian_1m.json").read_text())
UNIFORM = json.loads((BENCH / "configs" / "uniform_1m.json").read_text())
CELL = "gaussian_1m.move_all"
TINY = "tiny_gaussian.move_all"
TINY_N = 3000
# cut so that a hotspot's core fills leaves at l_max past th_quad and past
# one window, as 1M objects fill them at l_max 8
TINY_SPEC = {"l_max": 4, "th_quad": 16, "window": 32, "chunk": 1024}
NEW = ("live_row_pct", "tail_passes", "cand_per_row_pass", "scan_device_ms")


def test_config_is_table_1s_setting_with_uniform_1ms_spec():
    data, spec = CONF["data"], CONF["spec"]
    assert data["distribution"] == "gaussian"
    assert data["n_objects"] == 1_000_000
    assert data["side"] == spec["side"] == 22_500.0
    assert data["max_speed"] == 200.0 and spec["k"] == 32
    assert spec == UNIFORM["spec"] and CONF["check"] == UNIFORM["check"]
    assert CONF["guarantees"] == UNIFORM["guarantees"]
    assert CONF["reference"] == UNIFORM["reference"] == "knn_exact"
    assert data["hotspots"] == 25 and data["hotspot_sigma_frac"] == 1 / 64
    assert {"hotspots", "hotspot_sigma_frac", "centers",
            "n_objects"} <= set(CONF["assumed"])


def test_centers_are_the_seed_0_draw():
    want = np.random.default_rng(0).uniform(0, 22_500.0, (25, 2))
    assert np.array_equal(np.asarray(CONF["data"]["centers"]), want)


def test_manifest_runs_the_configuration_in_one_cell_on_one_chip():
    conf = next(c for c in MAN["configs"] if c["name"] == CONF["name"])
    assert conf["file"] == "knnbench/configs/gaussian_1m.json"
    assert conf["reduced"] == [] and conf["source"] == CONF["source"]
    cells = [w for w in MAN["workloads"] if w["config"] == CONF["name"]]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [
        (CELL, "move_all", 1)]
    for name in NEW:
        m = next(m for m in MAN["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["uniform_1m.move_all", CELL]
        assert m["moves"] == "queries_per_s"


@pytest.fixture
def gaussian_root(tmp_path):
    """A checkout's benchmark files beside a tiny gaussian configuration:
    ``gaussian_1m`` at 3,000 objects, every row checked, its index cut
    (``TINY_SPEC``)."""
    shutil.copytree(BENCH, tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    conf = dict(CONF, name="tiny_gaussian",
                data=dict(CONF["data"], n_objects=TINY_N),
                spec=dict(CONF["spec"], **TINY_SPEC),
                check={"rows_per_tick": TINY_N, "ticks": 64})
    (tmp_path / "knnbench" / "configs" / "tiny_gaussian.json").write_text(
        json.dumps(conf))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_gaussian", "source": "test",
                           "file": "knnbench/configs/tiny_gaussian.json",
                           "reduced": ["n_objects"], "why": "test"})
    man["workloads"].append({"name": TINY, "config": "tiny_gaussian",
                             "traffic": "move_all", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp_path


@pytest.fixture
def kept_sessions(monkeypatch):
    """The sessions a run makes, kept past the run's end."""
    from repro_torch import api

    kept = []

    class Kept(api.KnnSession):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept.append(self)

    monkeypatch.setattr(api, "KnnSession", Kept)
    return kept


def _run(root, monkeypatch, trace):
    from knnbench import harness

    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    monkeypatch.setattr(sys, "argv", [
        "knnbench/run.py", "--workload", TINY, "--seed", str(2**31 + 23),
        "--seconds", "1", "--trace", str(int(trace))])
    out, err = io.StringIO(), io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the suite's other workers
    try:
        rc = harness.run_cell(root / "BENCHMARK.json", TINY, 2**31 + 23, 1.0,
                              trace, device="cpu", forbidden=(), out=out,
                              err=err)
    finally:
        torch.set_num_threads(threads)
        from repro_torch import tracing

        tracing.disable()
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_tiny_gaussian_cell_runs_correct_over_overfull_leaves(
        gaussian_root, kept_sessions, monkeypatch):
    rc, res, err = _run(gaussian_root, monkeypatch, trace=False)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["rows_checked"] == TINY_N * res["ticks"]
    assert not set(NEW) & set(res["metrics"])
    # the regime of the 1M cell: leaves at l_max (one finest cell each)
    # holding more objects than th_quad and than one window
    (session,) = kept_sessions
    index = session.index
    assert index.l_max == TINY_SPEC["l_max"]
    pops = (index.starts[1:] - index.starts[:-1])[
        index.leaf_level == index.l_max]
    over = pops > max(TINY_SPEC["th_quad"], TINY_SPEC["window"])
    assert int(over.sum()) >= 2
    # most objects stand in such leaves, as in the 1M cell
    assert int(pops[over].sum()) > TINY_N // 2


def test_tiny_gaussian_cell_traced_reports_the_sweeps_new_metrics(
        gaussian_root, monkeypatch):
    rc, res, err = _run(gaussian_root, monkeypatch, trace=True)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    m = {name: v["value"] for name, v in res["metrics"].items()}
    assert set(m) == set(NEW)  # the cell's only per-layer metrics
    assert 0 < m["live_row_pct"] < 100
    assert 0 < m["tail_passes"]
    assert 0 < m["cand_per_row_pass"] <= TINY_SPEC["window"]
    # on the CPU the scan's device extent is its host duration
    assert 0 < m["scan_device_ms"] < min(res["window"]["tick_ms"])
    assert res["metrics"]["tail_passes"]["unit"] == "passes/tick"
