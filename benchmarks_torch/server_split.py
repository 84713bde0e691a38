#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py``'s server path goes, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/server_split.py [--n-objects 1000000]

Runs ``chip_smoke.server_path`` once (four tenants over N uniform objects,
spatial invalidation, with all of its checks) and times on the host clock
each call it makes: the server's ``submit()`` and ``result()``, the tenants'
delta ingest (where the stab runs), the row assembly per group, the solo
and stats twins' ticks, the brute-force oracle, the numpy reckoning of the
stats session, the other object and query ingests.  Only the outermost of
nested timed calls counts in ``parts``, so the parts and ``rest`` sum to
``total``; ``inside`` times some of the nested calls (the dedup, the cache
inserts, the stab), and ``gc`` the garbage collector's pauses wherever they
fell.  Prints one JSON line with the card's name and power limit.  Exits
non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

import common

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-objects", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("server_split: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.api import session as session_mod
    from repro_torch.serve import cache, registry, server, tenant

    parts = defaultdict(float)
    inside = defaultdict(float)
    depth = [0]

    def timed(owner, name, key, nested=False):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            if depth[0] and not nested:
                return fn(*a, **kw)
            depth[0] += 0 if nested else 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                (inside if nested else parts)[key] += time.perf_counter() - t0
                depth[0] -= 0 if nested else 1

        setattr(owner, name, wrapper)

    timed(server.KnnServer, "submit", "server submit")
    timed(server.ServerTick, "result", "server result")
    timed(server.ServerTick, "result_for", "server result_for")
    timed(tenant.TenantHandle, "update_objects", "tenant delta ingest")
    timed(tenant.TenantHandle, "register_queries", "tenant register")
    timed(server.KnnServer, "ingest_objects", "server snapshot ingest")
    timed(session_mod.KnnSession, "ingest_objects", "twin ingest")
    timed(session_mod.KnnSession, "update_objects", "twin delta ingest")
    timed(session_mod.KnnSession, "register_queries", "twin register")
    timed(chip_smoke, "_tick", "twin and stats ticks")
    timed(chip_smoke, "oracle_check", "oracle")
    timed(chip_smoke, "_sink_reckoning", "stats reckoning")
    timed(registry.TenantRegistry, "compute_view", "dedup", nested=True)
    timed(cache.ResultCache, "insert", "cache inserts", nested=True)
    timed(cache.ResultCache, "geometry", "cache geometry", nested=True)
    timed(server, "ball_stab_mask", "stab", nested=True)
    timed(session_mod.KnnSession, "submit", "session submits", nested=True)

    pauses = []

    def on_gc(phase, info):
        if phase == "start":
            pauses.append(time.perf_counter())
        elif pauses:
            inside["gc"] += time.perf_counter() - pauses.pop()

    from repro_torch.kernels import build

    build.build_all()  # outside the timed run
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        chip_smoke.server_path(torch.device("cuda"), args.n_objects)
        total = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    print(json.dumps({
        "card": common.card_line(), "n_objects": args.n_objects,
        "total": total, "parts": dict(parts),
        "rest": total - sum(parts.values()), "inside": dict(inside)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
