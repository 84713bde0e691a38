"""One run of one benchmark cell of ``repro_torch``, driven by data.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names a deployment, found at
the ``file`` its ``configs`` entry gives, and a traffic mix, found at
``<bench>/mixes/<mix>.json``; each metric is a reader at
``<bench>/metrics/<name>.py`` and each configuration's plain reference one at
``<bench>/references/<reference>.py``, where ``<bench>`` is the manifest's
first path.  Nothing here names a cell, a mix or a metric.

A run, through the port's public serving entry ``repro_torch.api.KnnSession``:

1. set-up: the traffic from the seed (every frame and draw, before any
   clock that a metric reads), the session, the ingest of frame 0 with one
   query per object at its own position excluding itself, the build tick
   and ``WARM_TICKS`` ticks of the cell's own traffic;
2. the window, a closed loop of one tick at a time for ``seconds``: hand in
   the positions (a snapshot, or the reporting objects' rows), move every
   query to its object's held position, ``submit()``, ``result()``; the
   tick in flight at the close finishes and counts;
3. under ``trace``, more ticks after the close under ``torch.profiler``:
   the device alone over one cycle of the frame schedule, or
   ``TRACE_SECONDS``, whichever ends first, then ``GAP_TICKS`` ticks with
   the host's operations too (``trace.py``);
4. then the peak memory, the look for JAX in ``sys.modules``,
   the program's state freed, then the check (``check.py``) against the
   configuration's reference, and one JSON line.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from knnbench import check, trace as trace_mod
from knnbench.traffic import Traffic

WARM_TICKS = 2
TRACE_SECONDS = 10.0
GAP_TICKS = 2  # ticks traced with the host's operations, to name idle gaps
# each window tick's parts on the host's clock, printed tick by tick
HOST_PARTS = ("tick_s", "hand_in_s", "submit_s", "result_s", "collect_s")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PORT = "repro_torch"


@dataclass
class Run:
    """What a metric reader reads: the window's ticks, the traced stretch."""

    n_objects: int
    k: int
    setup_s: float
    window_s: float
    memory_peak_bytes: int
    ticks: list = field(default_factory=list)  # one dict per window tick
    traced: list = field(default_factory=list)  # the traced ticks after it
    trace: trace_mod.Trace | None = None


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"knnbench: no {what} named {name!r} in BENCHMARK.json")


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"knnbench_{tag}", path)
    if spec is None:
        raise SystemExit(f"knnbench: cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None, names=FORBIDDEN) -> list[str]:
    """Loaded modules whose top-level name is one of ``names``, whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in names})


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Cell:
    """A cell's manifest entries and data files, found by name."""

    def __init__(self, manifest: Path, workload: str):
        self.root = manifest.parent
        man = json.loads(manifest.read_text())
        self.entry = _by_name(man["workloads"], workload, "workload")
        conf = _by_name(man["configs"], self.entry["config"], "config")
        self.bench = self.root / man["paths"][0]
        self.config = json.loads((self.root / conf["file"]).read_text())
        self.mix = json.loads(
            (self.bench / "mixes" / f"{self.entry['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics
                    if workload in m.get("workloads", [workload])]

        self.end_to_end = mine(man["end_to_end"])
        self.per_layer = mine(man["per_layer"])
        self.readers = {m["name"]: _load(self.bench / "metrics"
                                         / f"{m['name']}.py", m["name"])
                        for m in self.end_to_end + self.per_layer}
        self.reference = _load(
            self.bench / "references" / f"{self.config['reference']}.py",
            self.config["reference"])

    def spec_fields(self) -> dict:
        return {**self.config["spec"], **self.mix.get("spec", {})}


def run_cell(manifest: Path, workload: str, seed: int, seconds: float,
             trace: bool, device=None, t_start: float | None = None,
             forbidden=FORBIDDEN, out=None, err=None) -> int:
    """Run one cell and print its result line; returns the exit code.

    ``device=None`` is the benchmark: the card, which has to be there.  The
    tests pass ``device="cpu"`` (and ``forbidden=()``, since their process
    holds JAX) to drive the rest of a run at a small size.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    import torch

    phases = {"torch": time.perf_counter() - t_start}
    cell = Cell(Path(manifest), workload)
    if device is None:
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"knnbench: the cell needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.kernels.build import build_seconds

    phases["port"] = time.perf_counter() - t_start

    def port(name):
        return importlib.import_module(f"{PORT}.{name}")

    counters = {name: r.counter for name, r in cell.readers.items()
                if hasattr(r, "counter")}
    spec = ServiceSpec(**cell.spec_fields())
    check_cfg = cell.config["check"]
    traffic = Traffic(cell.config["data"], cell.mix, seed,
                      check_cfg["rows_per_tick"])
    n, k = traffic.n, spec.k
    phases["traffic"] = time.perf_counter() - t_start
    session = KnnSession(spec, device=device)
    dev = session.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    from torch.profiler import record_function

    qid = np.arange(n, dtype=np.int32)
    held = traffic.frame(0).copy()
    session.ingest_objects(held)
    handle = session.register_queries(held, qid)
    session.submit().result()  # the build tick, step 0
    phases["build_tick"] = time.perf_counter() - t_start

    def tick(step: int):
        # the harness's own work, before the tick's clock starts
        if traffic.snapshot:
            qpos, delta = traffic.frame(step), None
        else:
            ids = traffic.report_ids(step)
            delta = (ids, traffic.frame(step)[ids])
            held[ids] = delta[1]
            qpos = held
        before = {name: c(port) for name, c in counters.items()}
        with record_function(trace_mod.TICK_SPAN):
            t0 = time.perf_counter()
            with record_function("knnbench.hand_in"):
                if delta is None:
                    session.ingest_objects(qpos)
                else:
                    session.update_objects(*delta)
                session.update_queries(handle, qpos)
            t1 = time.perf_counter()
            with record_function("knnbench.submit"):
                h = session.submit()
            t2 = time.perf_counter()
            with record_function("knnbench.result"):
                res = h.result()
            t3 = time.perf_counter()
        rows = traffic.sample_rows(step)
        rec = {
            "step": step, "rows": int(res.nn_idx.shape[0]),
            "tick_s": t3 - t0, "hand_in_s": t1 - t0, "submit_s": t2 - t1,
            "result_s": t3 - t2, "collect_s": res.collect_s,
            "iterations": res.iterations, "candidates": res.candidates,
            "rebuilt": bool(res.rebuilt), "maintenance": res.maintenance,
            "counters": {name: c(port) - before[name]
                         for name, c in counters.items()},
            "end": t3,
            "sample": (rows, res.nn_idx[rows].copy(), res.nn_dist[rows].copy()),
        }
        return rec, res

    step = 1
    for _ in range(WARM_TICKS):
        tick(step)
        step += 1
    if on_card:
        torch.cuda.synchronize()
    compile_setup = build_seconds()
    t_win = time.perf_counter()
    phases["warm_up"] = t_win - t_start
    ticks = []
    while True:
        rec, res = tick(step)
        ticks.append(rec)
        step += 1
        if rec["end"] - t_win >= seconds:
            break
    window_s = ticks[-1]["end"] - t_win
    compile_window = build_seconds() - compile_setup
    last_qpos = traffic.frame(rec["step"]) if traffic.snapshot else held.copy()
    last_res = res
    traced, events, named = [], None, None
    if trace:
        # after the window, so that no metric but the trace's own reads a
        # profiled tick.  The device's busy time and kernels come from a
        # trace of the device alone over one cycle of the frame schedule, or
        # TRACE_SECONDS, whichever ends first, timed by the host's clock: it
        # records no host operation, which would slow the host more.  Then
        # GAP_TICKS ticks traced with the host's operations name the idle
        # gaps.
        from torch.profiler import ProfilerActivity, profile
        cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
        cycle = max(1, 2 * (traffic.frames - 1))
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=[cuda] if on_card else [cpu]) as prof:
            t_tr = time.perf_counter()
            while len(traced) < cycle and (
                    time.perf_counter() - t_tr < TRACE_SECONDS):
                traced.append(tick(step)[0])
                step += 1
            if on_card:
                torch.cuda.synchronize()
            t_stop = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        traced_s = t_stop - t_tr
        phases["trace_stop"] = time.perf_counter() - t_stop
        with profile(activities=[cpu, cuda] if on_card else [cpu]) as prof:
            for _ in range(GAP_TICKS):
                tick(step)
                step += 1
        named = prof.profiler.kineto_results.events()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    loaded = forbidden_loaded(names=forbidden)
    if loaded:
        print(f"knnbench: the run loaded {', '.join(loaded)}", file=err)
        return 3

    # the program's state goes before the reference runs
    del session, handle, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run = Run(n_objects=n, k=k, setup_s=t_win - t_start, window_s=window_s,
              memory_peak_bytes=peak, ticks=ticks, traced=traced)
    if trace:
        t_red = time.perf_counter()
        run.trace = trace_mod.reduce(events, traced_s, named)
        phases["trace_reduce"] = time.perf_counter() - t_red
        phases["trace_events"] = len(events) + len(named)
        del events, named

    # the check: sampled rows of the checked ticks, every row of the last
    checked = traffic.checked(len(ticks), int(check_cfg["ticks"]))
    checks, rows_checked = check.compare(
        cell.reference, traffic,
        {ticks[i]["step"]: ticks[i]["sample"] for i in checked},
        (last_qpos, last_qpos, qid, last_res.nn_idx, last_res.nn_dist), k, dev)
    correct = check.correct(checks)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if on_card else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_rec["busy_s"] = run.trace.busy_s
        device_rec["window_s"] = run.trace.window_s
    line = {"correct": correct, "attempted": sum(t["rows"] for t in ticks),
            "failed": 0, "metrics": metrics, "device": device_rec}
    if trace:
        line["breakdown"] = run.trace.breakdown()
    line.update({
        "card": card_line() if on_card else "cpu", "seed": seed,
        "ticks": len(ticks), "traced_ticks": len(traced),
        "window": {"iterations": [t["iterations"] for t in ticks],
                   "rebuilt": sum(t["rebuilt"] for t in ticks),
                   **{f"{part[:-2]}_ms": [1e3 * t[part] for t in ticks]
                      for part in HOST_PARTS}},
        "traced_tick_ms": [1e3 * t["tick_s"] for t in traced],
        "compile_s": compile_setup, "compile_in_window_s": compile_window,
        "phases_s": phases,
        "after_window_s": time.perf_counter() - t_win - window_s,
        "rows_checked": rows_checked, "ticks_checked": len(checked),
        "checks": checks,
    })
    if compile_window:
        print(f"knnbench: {compile_window} s of kernel builds inside the "
              "window", file=err)
    print(json.dumps(line), file=out)
    out.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    return 0
