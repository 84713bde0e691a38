"""End-to-end driver for the paper's kind: SERVE repeated k-NN query batches,
on the card.

The reference's driver (``examples/moving_objects_service.py``) over the
PyTorch port.  30 ticks (as in the paper's evaluation) of 50K moving
objects, one k-NN query per object per tick, timeslice semantics, index
reuse and a drift-triggered rebuild, through the session API
(``repro_torch.api``): a ``KnnSession`` built from a declarative
``ServiceSpec`` owns device-resident object and query state; queries are
registered ONCE and moved in place, object motion streams in as delta
scatters (``--ingest delta``) or full snapshots (``--ingest snapshot``), and
``--overlap`` submits tick t+1 while tick t's results are still in flight.
Runs on any execution plan: ``single``, ``sharded`` (query shards),
``object_sharded`` (Morton-sliced objects, a quadtree per slice, lists
merged) or ``hybrid`` (a ``(query, object)`` grid; pick it with
``--mesh QxO``).  The mesh plans run ``--devices`` / ``--mesh`` logical
shards one after another on the one card.  ``--partitioner cost_balanced``
swaps the equal-count splits for cost-balanced boundaries (same bits).

``--collect stats`` swaps the per-tick ``(Q, k)`` host transfer for the
on-device sink's aggregates; ``--precision mixed`` runs the sweep as a bf16
prune and an exact fp32 refine with bitwise-identical results.
``--maintenance incremental`` splices only the moved rows into the sorted
order each tick; pair it with ``--churn F`` to move a random fraction ``F``
of the objects per tick.  ``--backend fused_bucket`` runs the SCAN merge as
the hand-written CUDA kernel.

  PYTHONPATH=src python examples_torch/moving_objects_service.py \\
      [--objects N] [--ticks T] [--device cuda|cpu] \\
      [--distribution uniform|gaussian|network|zipf|hotspot_cluster] \\
      [--backend dense_topk|fused_bucket|brute] \\
      [--plan single|sharded|object_sharded|hybrid] [--devices D] \\
      [--mesh QxO] [--partitioner equal|cost_balanced] \\
      [--ingest snapshot|delta] [--overlap] [--churn F] \\
      [--maintenance rebuild|incremental] \\
      [--precision fp32|mixed] [--merge dense_merge|fused_merge|fused_multi] \\
      [--collect full|stats|none] [--tenants N]

``--tenants N`` (N > 1) serves the same workload through the multi-tenant
``repro_torch.serve.KnnServer`` instead of a solo session: the query batch
splits round-robin across N tenants sharing one tick, and each tick's object
delta arrives via the next tenant in turn.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.data import make_workload
from repro_torch.runtime import resolve_device


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=50_000)
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--distribution", default="gaussian",
                    choices=["uniform", "gaussian", "network", "zipf",
                             "hotspot_cluster"])
    ap.add_argument("--backend", default="dense_topk",
                    help="SCAN-step selection backend (validated eagerly by "
                         "ServiceSpec against the executor registry)")
    ap.add_argument("--plan", default="single",
                    choices=["single", "sharded", "object_sharded", "hybrid"],
                    help="execution plan (plan registry)")
    ap.add_argument("--devices", type=int, default=None,
                    help="logical shards on the plan's 1-D mesh, run one "
                         "after another on the one card")
    ap.add_argument("--mesh", default=None, metavar="QxO",
                    help="hybrid mesh shape, e.g. 2x4 (query x object "
                         "shards); default: most balanced factorization")
    ap.add_argument("--partitioner", default="equal",
                    choices=["equal", "cost_balanced"],
                    help="work partitioner for the plan's split axes: equal "
                         "count, or cost-balanced boundaries")
    ap.add_argument("--chunk", type=int, default=8192,
                    help="query chunk rows; batches pad to shards*chunk, so "
                         "use a small chunk for small smoke runs")
    ap.add_argument("--ingest", default="snapshot",
                    choices=["snapshot", "delta"],
                    help="object motion path: full-snapshot upload per tick, "
                         "or device-side delta scatter (update_objects)")
    ap.add_argument("--overlap", action="store_true",
                    help="submit tick t+1 while tick t's results are in "
                         "flight (double-buffer staging vs compute)")
    ap.add_argument("--maintenance", default="rebuild",
                    choices=["rebuild", "incremental"],
                    help="per-tick index refresh: full re-sort, or the "
                         "delta splice that pays for churn, not for N "
                         "(bitwise-identical results)")
    ap.add_argument("--churn", type=float, default=1.0, metavar="F",
                    help="fraction of objects that actually move per tick "
                         "(default 1.0 = all); with --ingest delta only the "
                         "churned rows cross the host, which is what lets "
                         "--maintenance incremental engage")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "mixed"],
                    help="sweep precision: fp32, or the bf16 prune + exact "
                         "fp32 refine pass (bitwise-identical results)")
    ap.add_argument("--merge", default="dense_merge",
                    help="MERGE backend for the merge-axis plans "
                         "(object_sharded/hybrid); fused_multi collapses "
                         "the reduction into one multi-way kernel pass")
    ap.add_argument("--collect", default="full",
                    choices=["full", "stats", "none"],
                    help="result delivery: full (Q,k) lists, on-device "
                         "sink aggregates only (stats), or nothing (none)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve N tenants through ONE shared KnnServer "
                         "tick (repro_torch.serve): the query batch splits "
                         "round-robin across tenants and each tick's object "
                         "delta is fed by the next tenant in turn; 1 "
                         "(default) = the solo KnnSession path")
    ap.add_argument("--invalidation", default="epoch",
                    choices=["epoch", "spatial"],
                    help="result-cache invalidation mode of the --tenants "
                         "server: epoch clears the store on every delta; "
                         "spatial evicts only entries whose k-th-distance "
                         "ball a moved row stabs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)

    mesh_shape = args.devices
    if args.mesh:
        try:
            q, o = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh must look like 2x4, got {args.mesh!r}")
        mesh_shape = (q, o)

    dev = resolve_device(args.device)
    try:
        spec = ServiceSpec(k=args.k, th_quad=384, l_max=8,
                           window=min(256, args.chunk), chunk=args.chunk,
                           backend=args.backend, plan=args.plan,
                           mesh_shape=mesh_shape,
                           partitioner=args.partitioner,
                           maintenance=args.maintenance,
                           precision=args.precision, merge=args.merge,
                           collect=args.collect)
    except ValueError as e:  # eager validation lists the registries
        raise SystemExit(str(e))

    if args.tenants > 1:
        return _serve_tenants(args, spec, dev)

    session = KnnSession(spec, device=dev)
    workload = make_workload(args.objects, args.distribution, seed=0)
    all_ids = np.arange(args.objects, dtype=np.int32)

    print(f"serving {args.objects} objects x {args.ticks} ticks "
          f"({args.distribution}, k={args.k}, backend={args.backend}, "
          f"ingest={args.ingest}, overlap={args.overlap}, "
          f"maintenance={args.maintenance}, churn={args.churn:g}, "
          f"precision={args.precision}, collect={args.collect})")
    print(f"{session.plan.describe()}  (on {_device_name(dev)})")

    def on_tick(res, tick_s):
        # under --overlap, res.wall_s spans submit..collection (one round
        # late); tick_s is the true per-round serve time measured here
        extra = f" compile={res.compile_s:.2f}s" if res.compile_s else ""
        if args.maintenance != "rebuild":
            extra += f" maint={res.maintenance}"
        if res.aggregates is not None:  # --collect stats: the sink's O(Q)
            a = res.aggregates
            extra += (f" drift={float(a.kth_drift_mean):.1f}"
                      f" churn={float(a.churn_mean):.3f}")
        print(f"tick {res.tick:2d}: {tick_s * 1e3:7.1f} ms "
              f"({args.objects / max(tick_s, 1e-9) / 1e3:6.1f}K q/s) "
              f"iters={res.iterations:3d} "
              f"cand/q={res.candidates / args.objects:6.0f} "
              f"{'REBUILT' if res.rebuilt else ''}{extra}")

    # seed device-resident state once; thereafter only motion crosses the host
    session.ingest_objects(workload.positions())
    cur = np.asarray(workload.positions(), np.float32).copy()
    churn_rng = np.random.default_rng(1)
    qpos, qid = workload.query_batch(1.0)
    hq = session.register_queries(qpos, qid)

    results, rounds, pending = [], [], None
    last = time.perf_counter()

    def collect(handle):
        results.append(handle.result())
        nonlocal last
        now = time.perf_counter()
        rounds.append(now - last)
        last = now
        on_tick(results[-1], rounds[-1])

    for t in range(args.ticks):
        if t > 0:
            workload.advance()
            new = np.asarray(workload.positions(), np.float32)
            if args.churn < 1.0:
                # only a random F-fraction of the fleet actually moves:
                # the regime the incremental maintenance path is built for
                d = max(1, int(round(args.objects * args.churn)))
                ids = churn_rng.choice(args.objects, d,
                                       replace=False).astype(np.int32)
                cur[ids] = new[ids]
            else:
                ids, cur = all_ids, new.copy()
            if args.ingest == "delta":
                session.update_objects(ids, cur[ids])
            else:
                session.ingest_objects(cur)
            session.update_queries(hq, workload.query_batch(1.0)[0])
        handle = session.submit()
        if pending is not None:
            collect(pending)
        if args.overlap:
            pending = handle  # collect after the NEXT submit is staged
        else:
            collect(handle)
            pending = None
    if pending is not None:
        collect(pending)  # drain round: compute already overlapped earlier

    # exclude the first (kernel build) round, and (when overlapped) the
    # near-zero drain round, from the steady-state figure
    steady = rounds[1:-1] if (args.overlap and len(rounds) > 2) else rounds[1:]
    if steady:
        print(f"\nsteady state: {np.median(steady) * 1e3:.1f} ms/tick = "
              f"{args.objects / np.median(steady):,.0f} queries/s "
              f"[{session.plan.describe()}] on {_device_name(dev)}")
    return 0


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _serve_tenants(args, spec, dev) -> int:
    """The --tenants N path: one shared KnnServer tick for every tenant.

    The query batch splits round-robin across tenants (tenant *i* owns rows
    ``i::N``), every tenant observes the SAME moving-object world, and each
    tick's object delta is fed by the next tenant in round-robin turn.  The
    per-tick hit rate shows how much device work the dedup and the result
    cache saved (under the default epoch invalidation it is 0 while every
    tick moves objects; --invalidation spatial keeps entries whose k-th ball
    no moved row stabbed).
    """
    from repro_torch.serve import KnnServer

    server = KnnServer(spec, device=dev, invalidation=args.invalidation)
    workload = make_workload(args.objects, args.distribution, seed=0)
    T = args.tenants

    print(f"serving {args.objects} objects x {args.ticks} ticks "
          f"across {T} tenants ({args.distribution}, k={args.k}, "
          f"ingest={args.ingest}, overlap={args.overlap}, "
          f"collect={args.collect}) on {_device_name(dev)}")

    server.ingest_objects(workload.positions())
    cur = np.asarray(workload.positions(), np.float32).copy()
    churn_rng = np.random.default_rng(1)
    qpos, qid = workload.query_batch(1.0)
    tenants, groups = [], []
    for i in range(T):
        t = server.admit(f"tenant-{i}")
        tenants.append(t)
        groups.append(t.register_queries(qpos[i::T], qid[i::T]))
    print(server.describe())

    rounds, pending = [], None
    last = time.perf_counter()

    def collect(st):
        res = st.result()
        nonlocal last
        now = time.perf_counter()
        rounds.append(now - last)
        last = now
        extra = f" compile={res.compile_s:.2f}s" if res.compile_s else ""
        print(f"tick {res.tick:2d}: {rounds[-1] * 1e3:7.1f} ms "
              f"rows={res.rows_total} computed={res.rows_computed} "
              f"hit={res.hit_rate:.2f} epoch={res.epoch}"
              f"{' REBUILT' if res.rebuilt else ''}{extra}")
        # each tenant's rows stay addressable; touch one to keep the path
        # honest
        server_rows = st.result_for(groups[res.tick % T])
        assert server_rows[0].shape[0] == groups[res.tick % T].count

    for t in range(args.ticks):
        if t > 0:
            workload.advance()
            new = np.asarray(workload.positions(), np.float32)
            if args.churn < 1.0:
                d = max(1, int(round(args.objects * args.churn)))
                ids = churn_rng.choice(args.objects, d,
                                       replace=False).astype(np.int32)
                cur[ids] = new[ids]
            else:
                ids, cur = np.arange(args.objects, dtype=np.int32), new.copy()
            if args.ingest == "delta":
                # round-robin: THIS tick's observations arrive via tenant t%T
                tenants[t % T].update_objects(ids, cur[ids])
            else:
                server.ingest_objects(cur)
            newq = workload.query_batch(1.0)[0]
            for i in range(T):
                tenants[i].update_queries(groups[i], newq[i::T])
        handle = server.submit()
        if pending is not None:
            collect(pending)
        if args.overlap:
            pending = handle
        else:
            collect(handle)
            pending = None
    if pending is not None:
        collect(pending)

    steady = rounds[1:-1] if (args.overlap and len(rounds) > 2) else rounds[1:]
    served = server.rows_served
    if steady:
        print(f"\nsteady state: {np.median(steady) * 1e3:.1f} ms/tick, "
              f"{T} tenants, {served} rows served, "
              f"{server.rows_computed} computed "
              f"(lifetime hit rate "
              f"{1 - server.rows_computed / max(served, 1):.2f}) "
              f"[{server.session.plan.describe()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
