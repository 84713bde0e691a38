#!/usr/bin/env python3
"""Do the fused_bucket and dense_topk backends serve the same ticks, on the card?

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/backend_agreement.py [--n-objects 1000000]

Two sessions of the PyTorch port, one per backend, get the same data: N
uniform objects with one query per object (qid = id), a build tick, two
ticks where 1% of the objects move up to 200 u, a ``gaussian`` (25
hotspots) snapshot tick and one more tick.  ``dense_topk`` merges by two
stable sorts, which is exact.  Per tick it prints, as one JSON line, the
rows whose lists differ between the two (ids or distance bits), and each
session's iterations, candidates, kernel launches and wall time.  Exits
non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import common

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-objects", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backend_agreement: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.data.generators import make_workload
    from repro_torch.kernels import fused_scan as fs

    print(common.card_line())
    n = args.n_objects
    spec = ServiceSpec(backend="fused_bucket")
    sessions = {b: KnnSession(dataclasses.replace(spec, backend=b))
                for b in ("fused_bucket", "dense_topk")}
    g = np.random.default_rng(args.seed + 1)
    pos = make_workload(n, "uniform", seed=args.seed,
                        side=spec.side).positions().copy()
    handles = {}
    for b, s in sessions.items():
        s.ingest_objects(pos)
        handles[b] = s.register_queries(pos, np.arange(n, dtype=np.int32))
    plan = ["uniform", "move 1%", "move 1%", "gaussian", "gaussian"]
    total_diff = 0
    for t, step in enumerate(plan):
        if step == "move 1%":
            ids, new = common.move_one_percent(pos, spec.side, g)
            for b, s in sessions.items():
                s.update_objects(ids, new)
                s.update_queries(handles[b], pos)
        elif step == "gaussian" and plan[t - 1] != "gaussian":
            pos = make_workload(n, "gaussian", seed=args.seed, side=spec.side,
                                hotspots=25).positions().copy()
            for b, s in sessions.items():
                s.ingest_objects(pos)
                s.update_queries(handles[b], pos)
        rec = {"tick": t, "step": step}
        res = {}
        for b, s in sessions.items():
            before = fs.fused_scan_merge.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[b] = s.submit().result()
            rec[b] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "iterations": res[b].iterations,
                      "candidates": res[b].candidates,
                      "launches": fs.fused_scan_merge.launches - before,
                      "rebuilt": res[b].rebuilt}
        a, d = res["fused_bucket"], res["dense_topk"]
        differ = ((a.nn_idx != d.nn_idx)
                  | (a.nn_dist.view(np.uint32) != d.nn_dist.view(np.uint32)))
        rec["rows_differing"] = int(differ.any(1).sum())
        total_diff += rec["rows_differing"]
        print(json.dumps(rec))
    print(json.dumps({"rows_differing_total": total_diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
