"""Quickstart: one batch of k-NN queries through the paper's pipeline, then
the same workload served statefully through the session API
(``repro_torch.api``: persistent queries, delta object updates), on the card.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.core import build_index, knn_bruteforce, knn_query_batch
from repro_torch.runtime import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    ap.add_argument("--objects", type=int, default=20_000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, k = args.objects, 8

    # moving-object positions at the end of a tick (synthetic, uniform)
    points = rng.uniform(0, 22_500, size=(n, 2)).astype(np.float32)
    pts = torch.tensor(points, device=dev)

    # stage (i)+(ii): build the PR-quadtree index (Morton sort + count pyramid)
    index = build_index(pts, (0.0, 0.0), 22_500.0, l_max=8, th_quad=192)

    # stage (iii): every object queries its k nearest neighbours (excl. itself)
    qid = torch.arange(n, dtype=torch.int32, device=dev)
    nn_idx, nn_dist, stats = knn_query_batch(index, pts, qid, k=k)

    print(f"processed {n} queries in {int(stats.iterations)} masked "
          f"iterations on {dev}")
    print(f"scanned {float(stats.candidates):.0f} candidate slots "
          f"({float(stats.candidates) / n:.0f} per query vs {n} brute-force)")
    print("first query's neighbours:", nn_idx[0].cpu().numpy())
    print("distances:", np.round(nn_dist[0].cpu().numpy(), 2))

    # verify against the brute-force oracle
    _, bd = knn_bruteforce(pts[:1000], pts[:256], qid[:256], k)
    small = build_index(pts[:1000], (0.0, 0.0), 22_500.0, l_max=6, th_quad=32)
    np.testing.assert_allclose(
        knn_query_batch(small, pts[:256], qid[:256], k=k)[1].cpu().numpy(),
        bd.cpu().numpy(), rtol=1e-5, atol=1e-3)
    print("matches brute force ✓")

    # ---- the serving view of the same problem: a session over ticks -------
    # queries persist across ticks; only object MOTION crosses the host.
    session = KnnSession(ServiceSpec(k=k, th_quad=192, l_max=7, window=128,
                                     chunk=2048, side=22_500.0), device=dev)
    session.ingest_objects(points)                     # snapshot seed
    hq = session.register_queries(points[:512], np.arange(512, dtype=np.int32))
    r0 = session.submit().result()                     # tick 0 (builds)
    moved = rng.choice(n, min(1_000, n), replace=False).astype(np.int32)
    session.update_objects(moved, points[moved] + 25.0)  # delta scatter
    r1 = session.submit().result()                     # tick 1, steady state
    print(f"session: tick0 {r0.wall_s * 1e3:.1f} ms (kernel build "
          f"{r0.compile_s:.2f} s), tick1 {r1.wall_s * 1e3:.1f} ms for "
          f"{session.query_count} persistent queries "
          f"(registered via {hq})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
