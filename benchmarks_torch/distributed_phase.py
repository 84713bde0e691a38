#!/usr/bin/env python3
"""``chip_smoke.py``'s object-axis paths and its ``distributed`` phase alone.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/distributed_phase.py [--n-objects 1000000]

Builds the kernels, runs ``chip_smoke.object_path`` for paths (a) and (b)
(the logical shards in turn on the card, each beside its ``single`` twin),
then ``chip_smoke.distributed`` (both paths again on gloo ranks that share
the card, one grid cell a rank, every rank held against the logical run bit
for bit) and ``chip_smoke.driver_ranks`` (the ``knn`` driver under
``torch.distributed.run`` on one NCCL rank), with every check of those
phases.  Prints their ``tick`` and ``distributed`` lines, then one JSON line
of seconds per part with the card's name and power limit.  Ranks that share
one card take turns on it: their walls are not multi-card walls.  Exits
non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import common

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-objects", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("distributed_phase: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import build

    card = common.card_line()
    seconds = {}
    t0 = time.perf_counter()
    build.build_all()
    seconds["build"] = time.perf_counter() - t0
    dev, n = torch.device("cuda"), args.n_objects
    kept, ticks = {"a": [], "b": []}, {}
    t0 = time.perf_counter()
    for label in ("a", "b"):
        _, ticks[label] = chip_smoke.object_path(dev, n, label, seed=0,
                                                 keep=kept[label])
    seconds["logical"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = chip_smoke.distributed(n, kept, ticks, card)
    seconds["ranks"] = time.perf_counter() - t0
    del kept
    t0 = time.perf_counter()
    chip_smoke.driver_ranks(n, card)
    seconds["driver"] = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "rank_launches": launches,
                      "n_objects": n, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
