#!/usr/bin/env python3
"""What the property harness costs on the card at full breadth.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/properties_cost.py

Runs the first draw of each property of ``repro_torch.properties`` (the
reference's shapes, its draws from ``repro_torch.testing``) on the card
over every SCAN backend and both kernel merges on the object-axis plans,
each backend timed on its own on the host clock, and the pinned mover and
the R-way composition.  Every cell must equal the ``single`` plan's bits,
as in the tests.  Prints one JSON line a property and backend
(``seconds``, ``cells``; for the maintenance and server axes also
``seconds_per_tick``: session ticks, the solo twins' included), then the
sum over the reference's draw counts (``full_breadth_s``: what
``chip_smoke.py``'s Part A would take unpruned) and the card's name and
power limit.  Exits non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

import common

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("dense_topk", "brute", "fused_bucket")
MERGES = ("fused_multi", "fused_merge")


def main() -> int:
    if not torch.cuda.is_available():
        print("properties_cost: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import properties as P
    from repro_torch.kernels import build
    from repro_torch.testing import draws

    build.build_all()
    dev = torch.device("cuda")
    # session ticks a maintenance / server cell runs: 2 x 5, and
    # 2 x 3 + 3 x 2 (both invalidations, then three solo twins)
    ticks = {"test_maintenance_axis_bit_identical": 10,
             "test_server_axis_bit_identical": 12}
    runs = {
        "test_full_matrix_bit_identical": lambda d, b: P.full_matrix(
            *d, device=dev, backends=(b,), merges=MERGES)[-1],
        "test_mixed_precision_bit_identical": lambda d, b: P.mixed_matrix(
            *d, device=dev, backends=(b,), merges=MERGES)[-1],
        "test_fewer_objects_than_k_all_plans": lambda d, b:
            P.fewer_objects_than_k(*d, device=dev, backends=(b,),
                                   merges=MERGES)[-1],
        "test_maintenance_axis_bit_identical": lambda d, b:
            P.maintenance_axis(*d, device=dev, backend=b, merges=MERGES),
        "test_server_axis_bit_identical": lambda d, b:
            P.server_axis(*d, device=dev, backend=b, merges=MERGES),
    }

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    total = 0.0
    for name, (strats, n) in P.PROPERTIES.items():
        (draw,) = draws(name, strats, 1)
        for backend in BACKENDS:
            cells, s = timed(lambda: runs[name](draw, backend))
            rec = {"property": name, "backend": backend, "draw": list(draw),
                   "cells": cells, "seconds": s}
            if name in ticks:
                rec["seconds_per_tick"] = s / (cells * ticks[name])
            print(json.dumps(rec), flush=True)
            total += s * n
    for name, fn in (
            ("test_mover_crosses_moving_cost_balanced_boundary",
             lambda: sum(P.mover_crosses_boundary(
                 device=dev, backend="fused_bucket", merge=m)
                 for m in MERGES)),
            ("test_pipeline_r_way_partition_composes",
             lambda: sum(P.r_way_partition(r, device=dev, backend=b, merge=m)
                         for r in (2, 3, 8)
                         for b, m in (("dense_topk", "dense_merge"),
                                      ("fused_bucket", MERGES[0]),
                                      ("fused_bucket", MERGES[1]))))):
        cells, s = timed(fn)
        print(json.dumps({"property": name, "cells": cells, "seconds": s}),
              flush=True)
        total += s
    print(json.dumps({"full_breadth_s": total, "card": common.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
