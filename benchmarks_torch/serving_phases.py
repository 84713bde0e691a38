#!/usr/bin/env python3
"""``chip_smoke.py``'s server on ranks and its ``lm`` phase alone.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/serving_phases.py [--n-objects 200000] [--skip-lm]

Builds the kernels, runs ``chip_smoke.server_ranks`` (the four-tenant
``KnnServer`` on ``object_sharded`` 4, logically and then one replica on
each of 4 gloo ranks sharing the card, every rank held against the logical
run bit for bit, then the ``knn`` driver with four tenants under
``torch.distributed.run``) and ``chip_smoke.lm_phase`` (``serve lm`` at full
width and depth, the nine other architectures at full width in bf16 with
their depth cuts, all ten at full width cut to 1 to 8 layers against
float32, and every smoke config's card float32 against the CPU),
with every check of those phases.  Prints their ``distributed`` and ``lm``
lines, then one JSON line of seconds per part with the card's name and
power limit.  Exits non-zero without a card.  Imports nothing of JAX.
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
    ap.add_argument("--n-objects", type=int, default=200_000)
    ap.add_argument("--skip-lm", action="store_true",
                    help="run the server on ranks only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_phases: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import build

    card = common.card_line()
    print(card, flush=True)
    seconds = {}
    t0 = time.perf_counter()
    build.build_all()
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = chip_smoke.server_ranks(args.n_objects, card)
    seconds["server_ranks"] = time.perf_counter() - t0
    if not args.skip_lm:
        t0 = time.perf_counter()
        chip_smoke.lm_phase(torch.device("cuda"), card)
        seconds["lm"] = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "rank_launches": launches,
                      "n_objects": args.n_objects, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
