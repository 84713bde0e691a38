"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to a file of its own."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(r) for r in c["reduced"])
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(CELLS)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"]
             + MAN["end_to_end"] + MAN["per_layer"]]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_files(cell):
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    bench = ROOT / MAN["paths"][0]
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert (bench / "references" / f"{data['reference']}.py").is_file()
    assert (bench / "mixes" / f"{w['traffic']}.json").is_file()
    mine = [m for m in MAN["end_to_end"] + MAN["per_layer"]
            if cell in m.get("workloads", CELLS)]
    for m in mine:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in mine if m in MAN["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in mine if m in MAN["per_layer"]]
    assert layer
    for m in layer:  # the metric it moves is one this cell reports
        assert m["moves"] in e2e


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
