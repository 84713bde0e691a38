"""The whole harness on the CPU at a tiny size: a cell added from new files
alone, the traced run, and the check failing under each fault the cells can
have."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from knnbench.conftest import TINY_CELLS

ROOT = Path(__file__).resolve().parents[1]


def _digest(root: Path, names):
    return {n: hashlib.sha256((root / n).read_bytes()).hexdigest()
            for n in names}


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_a_cell_added_from_new_files_alone_runs_correct(cell, run_tiny,
                                                       tiny_root):
    old = [str(p.relative_to(tiny_root)) for p in
           (tiny_root / "knnbench").rglob("*.py")]
    before = _digest(tiny_root, old)
    rc, res, err = run_tiny(cell)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    # no peak_mem_gib on the CPU, which holds no device memory
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    assert res["attempted"] == 2000 * res["ticks"] and res["failed"] == 0
    assert res["rows_checked"] == 2000 * res["ticks"]
    assert err.strip().splitlines()[-2:] == [
        "check rows_differ 0 limit 0", "check lists_bad 0 limit 0"]
    assert _digest(tiny_root, old) == before


def test_traced_run_reports_the_per_layer_metrics(run_tiny):
    rc, res, err = run_tiny("tiny_uniform.tiny_churn", trace=True)
    assert rc == 0, err
    assert res["correct"] is True
    m = res["metrics"]
    # on the CPU no kernel runs on a device: no B1 time, no idle share
    assert {"ingest_ms", "submit_ms", "collect_ms", "sweep_trips",
            "cand_per_query", "rebuild_pct", "b1_launches"} <= set(m)
    assert "b1_roofline" not in m and "device_idle_pct" not in m
    assert res["traced_ticks"] >= 1
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _patch_result(monkeypatch, alter):
    """Alter every tick's lists where the session hands them out."""
    from repro_torch.api import handles

    real = handles.TickHandle.result

    def result(self, materialize=True):
        res = real(self, materialize)
        if res.nn_idx is not None and not getattr(res, "_altered", False):
            alter(res)
            res._altered = True
        return res

    monkeypatch.setattr(handles.TickHandle, "result", result)


def test_check_fails_when_the_state_is_left_unchanged(run_tiny, monkeypatch):
    """A tick that keeps the objects where they were."""
    from repro_torch.api import session

    ingest = session.KnnSession.ingest_objects

    def stale_ingest(self, positions):
        if self._positions is None:
            ingest(self, positions)

    monkeypatch.setattr(session.KnnSession, "ingest_objects", stale_ingest)
    monkeypatch.setattr(session.KnnSession, "update_objects",
                        lambda self, ids, positions: None)
    for cell in TINY_CELLS:
        rc, res, _ = run_tiny(cell)
        assert rc == 0 and res["correct"] is False
        assert res["checks"]["rows_differ"]["value"] > 0


def test_check_fails_when_half_the_batch_is_left_out(run_tiny, monkeypatch):
    def half(res):
        h = res.nn_idx.shape[0] // 2
        res.nn_idx[h:] = res.nn_idx[:res.nn_idx.shape[0] - h]
        res.nn_dist[h:] = res.nn_dist[:res.nn_dist.shape[0] - h]

    _patch_result(monkeypatch, half)
    rc, res, _ = run_tiny()
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["rows_differ"]["value"] > 0
    assert res["checks"]["lists_bad"]["value"] > 0


def test_check_fails_when_one_answer_is_altered(run_tiny, monkeypatch):
    def one(res):
        row = int(np.random.default_rng(res.tick).integers(res.nn_idx.shape[0]))
        res.nn_idx[row, 3] = (res.nn_idx[row, 3] + 1) % res.nn_idx.shape[0]

    _patch_result(monkeypatch, one)
    rc, res, _ = run_tiny()
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["rows_differ"]["value"] == res["ticks"]
    assert res["checks"]["lists_bad"]["value"] == 1


def test_cli_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "knnbench/run.py", "--workload",
         "uniform_1m.move_all", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_cli_in_a_tree_of_only_the_benchmark_fails(tmp_path):
    """Without the program beside it the command exits non-zero, silently
    on standard output."""
    import shutil

    shutil.copytree(ROOT / "knnbench", tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "knnbench/run.py", "--workload",
         "uniform_1m.move_all", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
