"""Fixtures of the benchmark's CPU tests: a copy of the benchmark beside a
tiny configuration, run through the whole harness on the CPU."""
from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# the program, as run.py puts it on the path in a checkout
sys.path.insert(0, str(ROOT / "src"))
TINY_CELLS = ("tiny_uniform.move_all", "tiny_uniform.tiny_churn")


def add_tiny_cells(root: Path):
    """New files and manifest entries only: a tiny uniform configuration (2,000
    objects, every row checked) and a mix in which 5% of the objects report a
tick through delta updates, run as two cells."""
    bench = root / "knnbench"
    conf = json.loads((bench / "configs" / "uniform_1m.json").read_text())
    conf["name"] = "tiny_uniform"
    conf["data"]["n_objects"] = 2000
    conf["spec"]["chunk"] = 1024
    conf["check"] = {"rows_per_tick": 2000, "ticks": 64}
    (bench / "configs" / "tiny_uniform.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "mixes" / "move_all.json").read_text())
    mix.update(report_share=0.05, spec={"maintenance": "incremental"})
    (bench / "mixes" / "tiny_churn.json").write_text(json.dumps(mix))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_uniform", "source": "test",
                           "file": "knnbench/configs/tiny_uniform.json",
                           "reduced": ["n_objects"], "why": "test"})
    for cell in TINY_CELLS:
        man["workloads"].append({"name": cell, "config": "tiny_uniform",
                                 "traffic": cell.split(".")[1], "chips": 1,
                                 "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].extend(TINY_CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(man))


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout's benchmark files with the tiny cells added."""
    shutil.copytree(BENCH, tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_tiny_cells(tmp_path)
    return tmp_path


@pytest.fixture
def run_tiny(tiny_root, monkeypatch):
    """Run a tiny cell on the CPU; returns (exit code, result, stderr)."""
    from knnbench import harness
    from knnbench.harness import run_cell

    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)

    def run(cell="tiny_uniform.move_all", seed=2**31 + 11, seconds=0.8,
            trace=False):
        out, err = io.StringIO(), io.StringIO()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # beside the suite's other workers
        try:
            rc = run_cell(tiny_root / "BENCHMARK.json", cell, seed, seconds,
                          trace, device="cpu", forbidden=(), out=out, err=err)
        finally:
            torch.set_num_threads(threads)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

    return run
