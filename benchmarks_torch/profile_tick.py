#!/usr/bin/env python3
"""Where one tick of the PyTorch port's ``KnnSession`` spends its time, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/profile_tick.py [--n-objects 1000000] [--out DIR]

The session has the spec defaults and ``backend="fused_bucket"`` over N
uniform objects with one query per object (the main path of
``chip_smoke.py``).  After a build tick and a tick where 1% of the objects
move up to 200 u, one more such tick runs under ``torch.profiler``.  Printed:

- the tick's wall time, the device's busy time (the sum of its kernel,
  copy and fill intervals) and its idle share;
- device time by kernel name and by operator (the full tables go to
  ``DIR/tick_kernels.txt`` and ``DIR/tick_ops.txt``);
- the sweep's per-chunk trip counts on the profiled tick's index.  All chunks
  run in lockstep, so the sweep takes as many iterations as its slowest
  chunk; the rows that keep that chunk alive are listed.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import common

ROOT = Path(__file__).resolve().parents[1]


def move_one_percent(session, handle, pos, side, g):
    ids, new = common.move_one_percent(pos, side, g)
    session.update_objects(ids, new)
    session.update_queries(handle, pos)


def device_intervals(prof):
    """(name, microseconds) of every interval the card was busy."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def chunk_trips(session):
    """Per-chunk trip counts of the sweep on the session's current index."""
    from repro_torch.core import pipeline

    spec = session.spec
    index = session.index
    qpos, qid, *_ = session._registry.staged()
    order, _ = pipeline._sort_unsort(index, qpos)
    n_chunks = qpos.shape[0] // spec.chunk
    _, d2, st, cand_q = pipeline._knn_sorted_impl(
        index, qpos[order], qid[order], spec.k, spec.window,
        pipeline.default_max_nav(spec.l_max), spec.max_iters,
        session.executor, n_chunks=n_chunks)
    trips = st.iterations.cpu().numpy()
    worst = int(np.argmax(trips))
    rows = torch.arange(worst * spec.chunk, (worst + 1) * spec.chunk,
                        device=qpos.device)
    cq = cand_q[rows]
    top = rows[torch.argsort(cq, descending=True)[:5]]
    q_s = qpos[order]
    from repro_torch.core.quadtree import leaf_of_points

    key, lvl = leaf_of_points(index, q_s[top])
    span = torch.bitwise_left_shift(torch.ones_like(lvl), 2 * (index.l_max - lvl))
    own = (index.starts[(key + span).clamp(max=index.n_fine)]
           - index.starts[key])
    detail = [{
        "qpos": q_s[r].tolist(), "cand_q": float(cand_q[r]),
        "kth_dist": float(d2[r, -1].sqrt()), "leaf_level": int(lv),
        "own_leaf_objects": int(o),
    } for r, lv, o in zip(top.tolist(), lvl.tolist(), own.tolist())]
    return {
        "chunks": int(n_chunks), "sum": int(trips.sum()),
        "max": int(trips.max()), "p50": float(np.percentile(trips, 50)),
        "p90": float(np.percentile(trips, 90)),
        "top": sorted(trips.tolist())[-8:], "worst_chunk": worst,
        "worst_rows": detail,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-objects", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_tick: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.data.generators import make_workload
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_scan as fs

    card = common.card_line()
    print(card)
    build.build_all()
    n = args.n_objects
    spec = ServiceSpec(backend="fused_bucket")
    g = np.random.default_rng(args.seed + 1)
    pos = make_workload(n, "uniform", seed=args.seed,
                        side=spec.side).positions().copy()
    session = KnnSession(spec)
    session.ingest_objects(pos)
    handle = session.register_queries(pos, np.arange(n, dtype=np.int32))
    session.submit().result()  # build tick
    move_one_percent(session, handle, pos, spec.side, g)
    session.submit().result()  # warm delta tick
    move_one_percent(session, handle, pos, spec.side, g)
    torch.cuda.synchronize()
    before = fs.fused_scan_merge.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = session.submit().result()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = fs.fused_scan_merge.launches - before

    busy = defaultdict(float)
    for name, us in device_intervals(prof):
        busy[name] += us
    busy_us = sum(busy.values())
    by_kernel = sorted(busy.items(), key=lambda kv: -kv[1])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "tick_kernels.txt").write_text("".join(
        f"{us:14.1f} us  {us / busy_us:6.1%}  {name}\n"
        for name, us in by_kernel))
    (out / "tick_ops.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=60, max_name_column_width=60))
    summary = {
        "card": card, "n_objects": n, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "iterations": res.iterations, "candidates": res.candidates,
        "launches": launches,
        "top_kernels": [{"name": name[:90], "ms": us / 1e3,
                         "share_of_busy": us / busy_us}
                        for name, us in by_kernel[:12]],
    }
    print(json.dumps(summary))
    print(json.dumps({"chunk_trips": chunk_trips(session)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
