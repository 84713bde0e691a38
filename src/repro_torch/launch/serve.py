"""The k-NN serving entry point of the port.

Counterpart of the ``knn`` mode of ``repro/launch/serve.py``: repeated k-NN
query batches over moving objects, one batch per tick, served through a
:class:`repro_torch.api.KnnSession`, or with ``--tenants N`` through one
:class:`repro_torch.serve.KnnServer` shared by N tenants.  It runs on the card
unless given ``--device cpu``.

Under ``python -m torch.distributed.run --nproc-per-node N`` every process
joins the process group the launcher describes
(:func:`repro_torch.launch.mesh.init_from_env`: NCCL when every rank has a
card of its own, gloo on the CPU and when ranks share a card), and a mesh
plan lays one grid cell on each of the N ranks (its ``mesh_shape`` is left
None: the world size).
Every rank serves the same ticks; rank 0 prints the tick lines, and every
rank checks its own lists and that they equal every other rank's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve knn --objects 50000 --ticks 10 --k 32
  PYTHONPATH=src python -m repro_torch.launch.serve knn --objects 1000000 --ticks 3 --tenants 4
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve knn --plan object_sharded
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np
import torch.distributed as dist

from ..api import KnnSession, ServiceSpec
from ..data.generators import make_workload
from .mesh import init_from_env


def _check_lists(res, n_objects: int, k: int) -> str:
    """Raise unless every row is ``k`` ascending distances over object ids
    (``(inf, -1)`` padded); return a digest of the lists' bits."""
    idx, dist_ = res.nn_idx, res.nn_dist
    if idx.shape[1] != k or dist_.shape != idx.shape:
        raise AssertionError(f"tick {res.tick}: lists of shape {idx.shape}")
    filled = idx >= 0
    if (idx >= n_objects).any() or not np.isfinite(dist_[filled]).all() or (
            np.diff(dist_, axis=1) < 0).any() or not np.isinf(
            dist_[~filled]).all():
        raise AssertionError(f"tick {res.tick}: malformed lists")
    return hashlib.sha256(idx.tobytes() + dist_.tobytes()).hexdigest()


def serve_knn(args, device=None) -> int:
    """One session over ``--ticks`` ticks; ``device`` (this rank's, under a
    process group) overrides ``--device``."""
    spec = ServiceSpec(k=args.k, th_quad=args.th_quad, l_max=args.l_max,
                       chunk=args.chunk, plan=args.plan,
                       partitioner=args.partitioner, collect=args.collect,
                       maintenance=args.maintenance)
    ranked = dist.is_initialized()
    if args.tenants > 1:
        if ranked:
            raise ValueError("--tenants serves one KnnServer in one process; "
                             "it does not run under a process group")
        return serve_knn_tenants(args, spec)
    session = KnnSession(spec, device=device or args.device)
    lead = not ranked or dist.get_rank() == 0
    w = make_workload(args.objects, args.distribution, seed=args.seed)
    tput = []

    def on_tick(res, tick_s):
        # tick_s spans staging + submit + result, without the kernel build
        qps = args.objects / max(tick_s, 1e-9)
        tput.append(qps)
        extra = f" compile={res.compile_s:.2f}s" if res.compile_s else ""
        if not lead:
            return
        print(
            f"[knn] tick {res.tick}: {tick_s * 1e3:.1f} ms, "
            f"{qps / 1e3:.1f}K queries/s, iters={res.iterations} "
            f"rebuilt={res.rebuilt} maint={res.maintenance}{extra}",
            flush=True,
        )

    # queries registered once; --churn 1.0 ingests a whole snapshot a tick,
    # a fraction feeds only the moved rows through update_objects (the
    # regime where --maintenance incremental splices)
    session.ingest_objects(w.positions())
    cur = np.asarray(w.positions(), np.float32).copy()
    churn_rng = np.random.default_rng(args.seed + 1)
    hq = session.register_queries(*w.query_batch(1.0))
    for t in range(args.ticks):
        t0 = time.time()
        if t > 0:
            w.advance()
            new = np.asarray(w.positions(), np.float32)
            if args.churn < 1.0:
                d = max(1, int(round(args.objects * args.churn)))
                ids = churn_rng.choice(args.objects, d,
                                       replace=False).astype(np.int32)
                cur[ids] = new[ids]
                session.update_objects(ids, cur[ids])
            else:
                cur = new.copy()
                session.ingest_objects(cur)
            session.update_queries(hq, w.query_batch(1.0)[0])
        res = session.submit().result()
        on_tick(res, time.time() - t0 - res.compile_s)
        if res.nn_idx is not None:
            digest = _check_lists(res, args.objects, args.k)
            if ranked:
                digests = [None] * dist.get_world_size()
                dist.all_gather_object(digests, digest)
                if len(set(digests)) != 1:
                    raise AssertionError(f"tick {res.tick}: the ranks' lists "
                                         f"differ ({digests})")
    if not lead:
        return 0
    if ranked:
        print(f"[knn] {dist.get_world_size()} ranks ended every tick with "
              "the same lists", flush=True)
    if len(tput) > 1:
        print(f"[knn] steady-state throughput: {np.median(tput[1:]):.0f} "
              "queries/s")
    return 0


def serve_knn_tenants(args, spec) -> int:
    """N tenants through one shared server.

    Queries split round-robin across tenants; each tick's whole-population
    delta is fed by the next tenant in turn, so every tenant drives the
    shared-world path.
    """
    from ..serve import KnnServer

    server = KnnServer(spec, device=args.device)
    w = make_workload(args.objects, args.distribution, seed=args.seed)
    T = args.tenants
    server.ingest_objects(w.positions())
    qpos, qid = w.query_batch(1.0)
    tenants = [server.admit(f"tenant-{i}") for i in range(T)]
    groups = [t.register_queries(qpos[i::T], qid[i::T])
              for i, t in enumerate(tenants)]
    all_ids = np.arange(args.objects, dtype=np.int32)
    print(f"[knn] {server.describe()}")
    walls = []
    for t in range(args.ticks):
        t0 = time.time()
        if t > 0:
            w.advance()
            cur = np.asarray(w.positions(), np.float32)
            tenants[t % T].update_objects(all_ids, cur)
            newq = w.query_batch(1.0)[0]
            for i, tn in enumerate(tenants):
                tn.update_queries(groups[i], newq[i::T])
        res = server.submit().result()
        wall = time.time() - t0 - res.compile_s
        walls.append(wall)
        print(f"[knn] tick {res.tick}: {wall * 1e3:.1f} ms, "
              f"rows={res.rows_total} computed={res.rows_computed} "
              f"hit={res.hit_rate:.2f} epoch={res.epoch} "
              f"rebuilt={res.rebuilt}", flush=True)
    lifetime = 1 - server.rows_computed / max(server.rows_served, 1)
    if len(walls) > 1:
        print(f"[knn] {T} tenants steady-state: "
              f"{np.median(walls[1:]) * 1e3:.1f} ms/tick, lifetime hit rate "
              f"{lifetime:.2f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("knn")
    k.add_argument("--objects", type=int, default=50_000)
    k.add_argument("--ticks", type=int, default=10)
    k.add_argument("--k", type=int, default=32)
    k.add_argument("--th-quad", type=int, default=192)
    k.add_argument("--l-max", type=int, default=8)
    k.add_argument("--chunk", type=int, default=8192)
    k.add_argument("--distribution", default="uniform")
    k.add_argument("--plan", default="single")
    k.add_argument("--partitioner", default="equal")
    k.add_argument("--collect", default="full")
    k.add_argument("--maintenance", default="rebuild",
                   choices=["rebuild", "incremental"],
                   help="index maintenance: re-sort every row each tick, or "
                        "splice the moved rows into the live order")
    k.add_argument("--churn", type=float, default=1.0, metavar="F",
                   help="fraction of objects moved per tick; < 1.0 feeds "
                        "only the moved rows as a delta")
    k.add_argument("--tenants", type=int, default=1,
                   help="serve N tenants through one shared KnnServer; "
                        "1 = a solo KnnSession")
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    args = ap.parse_args(argv)
    ranks = init_from_env(args.device)
    if ranks is None:
        return serve_knn(args)
    dev, backend = ranks
    try:
        if dist.get_rank() == 0:
            print(f"[knn] process group: backend={backend} "
                  f"world={dist.get_world_size()}", flush=True)
        print(f"[knn] rank {dist.get_rank()} on {dev}", flush=True)
        return serve_knn(args, device=dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
