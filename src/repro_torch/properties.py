"""The composition-law property harness, on any device.

The port's counterpart of the reference's ``tests/test_properties.py``.
Selection is everywhere the canonical ``(d2, id)`` order, so a query's k-NN
list is a pure function of the candidate set: every plan x partitioner x
precision x maintenance x tenant cell must give the ``single`` plan's bits
(DESIGN.md §12-§16).  Each property below is a function of its drawn values
and a device; it raises ``AssertionError`` naming the first cell that differs
and returns how many cells it held.  ``tests/test_torch_properties.py`` runs
them on the CPU beside the JAX package; ``chip_smoke.py``'s ``properties``
phase runs the same draws on the card, where the SCAN backends and the
object-axis merges launch their kernels.

The mesh plans run :data:`NDEV` logical shards one after another, so the
grid has real 4-way object and query splits on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import (
    KDTree,
    available_backends,
    build_index,
    knn_query_batch_chunked,
    object_shard_capacity,
    resolve_executor,
    resolve_partitioner,
)
from .core import plan as plan_mod
from .core.balance import equal_boundaries
from .core.pipeline import _resolve_max_nav, _sort_unsort
from .core.plan import default_hybrid_shape
from .data import make_workload
from .kernels import tree_merge_lists
from .runtime import resolve_device, sqrt
from .testing import strategies as st

__all__ = [
    "SIDE",
    "NDEV",
    "PLAN_GRID",
    "PROPERTIES",
    "cloud",
    "queries",
    "check_oracle",
    "full_matrix",
    "mixed_matrix",
    "fewer_objects_than_k",
    "maintenance_axis",
    "mover_crosses_boundary",
    "server_axis",
    "r_way_partition",
]

NDEV = 4
SIDE = 22_500.0

# (plan, mesh_shape, partitioner): every registered plan, the mesh plans on
# NDEV logical shards under both registered partitioners
PLAN_GRID = (
    ("single", None, "equal"),
    ("sharded", NDEV, "equal"),
    ("sharded", NDEV, "cost_balanced"),
    ("object_sharded", NDEV, "equal"),
    ("object_sharded", NDEV, "cost_balanced"),
    ("hybrid", default_hybrid_shape(NDEV), "equal"),
    ("hybrid", default_hybrid_shape(NDEV), "cost_balanced"),
)

_CLOUD = (st.integers(0, 10_000),  # seed
          st.integers(0, 2),       # family
          st.integers(1, 6),       # dup_every
          st.floats(1.2, 3.5))     # zipf_a
# test name -> (strategies, max_examples), as the reference draws them
PROPERTIES = {
    "test_full_matrix_bit_identical": (_CLOUD, 6),
    "test_mixed_precision_bit_identical": (_CLOUD, 4),
    "test_fewer_objects_than_k_all_plans": (
        (st.integers(0, 10_000), st.integers(1, 7), st.integers(1, 3)), 5),
    "test_maintenance_axis_bit_identical": (
        (st.integers(0, 10_000), st.integers(0, 2), st.integers(1, 4),
         st.floats(1.2, 3.5)), 3),
    "test_server_axis_bit_identical": (_CLOUD, 3),
}


def cloud(seed: int, n: int, family: int, dup_every: int, zipf_a: float,
          zipf_kw=None):
    """One object cloud: 0=uniform, 1=gaussian hotspots, 2=Zipf-skewed
    clusters (the ``zipf`` preset, by default with the harness's tight
    hotspots; ``zipf_kw`` replaces its keywords); ``dup_every > 1``
    overlays exact coincident duplicates."""
    rng = np.random.default_rng(seed)
    if family == 0:
        pts = rng.uniform(0, SIDE, (n, 2))
    elif family == 1:
        c = rng.uniform(0, SIDE, (4, 2))
        pts = c[rng.integers(0, 4, n)] + rng.normal(0, SIDE * 0.01, (n, 2))
    else:
        kw = (dict(clusters=12, hotspot_sigma_frac=0.002) if zipf_kw is None
              else zipf_kw)
        pts = make_workload(n, "zipf", seed=seed, zipf_a=zipf_a, side=SIDE,
                            **kw).positions()
    if dup_every > 1:
        base = pts[: max(1, n // dup_every)]
        pts = np.tile(base, (dup_every + 1, 1))[:n]
        pts = pts[rng.permutation(n)]
    return np.clip(pts, 0, SIDE).astype(np.float32)


def queries(pts: np.ndarray, nq: int, seed: int):
    """Half coincident with objects (self-excluding qids), half external."""
    rng = np.random.default_rng(seed + 1)
    m = nq // 2
    own = rng.choice(pts.shape[0], size=m, replace=False)
    qpos = np.concatenate(
        [pts[own], rng.uniform(0, SIDE, (nq - m, 2)).astype(np.float32)]
    ).astype(np.float32)
    qid = np.concatenate(
        [own.astype(np.int32), np.full((nq - m,), -2, np.int32)]
    )
    return qpos, qid


def check_oracle(pts, qpos, qid, ii, dd, k):
    """Lists vs the kd-tree: exact distances per rank, id sets off ties."""
    ri, rd = KDTree(pts).query_batch(qpos, k, qid=qid)
    np.testing.assert_allclose(dd, rd, rtol=1e-5, atol=1e-3)
    for r in range(len(qpos)):
        kth = rd[r, k - 1]
        want = set(ri[r][rd[r] < kth * (1 - 1e-6)]) - {-1}
        got = set(ii[r][dd[r] < kth * (1 - 1e-6)]) - {-1}
        assert want == got, (r, want, got)


def _object_axis(plan: str, mesh) -> int:
    """Object-mesh axis size of a grid cell (1 = no object sharding)."""
    if plan == "object_sharded":
        return int(mesh)
    if plan == "hybrid":
        return int(mesh[1])
    return 1


def _cells(merges, grid=PLAN_GRID):
    """(plan, mesh, partitioner, merge): each object-axis cell once per
    merge, the others once with the default merge (None)."""
    for plan, mesh, part in grid:
        for merge in (merges if _object_axis(plan, mesh) > 1 else (None,)):
            yield plan, mesh, part, merge


def _same(got, want, tag):
    """(ids, distances) equal bit for bit."""
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"ids {tag}")
    np.testing.assert_array_equal(
        np.asarray(got[1], np.float32).view(np.uint32),
        np.asarray(want[1], np.float32).view(np.uint32),
        err_msg=f"dists {tag}")


def _index(pts, device, l_max=5, th_quad=8):
    return build_index(torch.tensor(pts, device=resolve_device(device)),
                       (0.0, 0.0), SIDE, l_max=l_max, th_quad=th_quad)


def _sweep(idx, qpos, qid, *, k, backend, plan, mesh, device,
           partitioner="equal", precision=None, merge=None):
    ii, dd, _ = knn_query_batch_chunked(
        idx, qpos, qid, k=k, window=16, chunk=16, backend=backend,
        precision=precision, plan=plan, num_devices=mesh,
        partitioner=partitioner, merge=merge, device=device,
    )
    return ii, dd


def _spec_kw(backend, merge):
    kw = dict(backend=backend)
    if merge is not None:
        kw["merge"] = merge
    return kw


def full_matrix(seed, family, dup_every, zipf_a, *, device, backends=None,
                merges=(None,)):
    """Every plan x partitioner (x merge) == that backend's ``single``
    bits, for each of ``backends`` (default: every registered one); every
    backend's ``single`` lists cross-agree up to distance rounding; the
    ``dense_topk`` lists meet the kd-tree oracle.  96 objects, 24 queries,
    k = 6.  Returns (cloud, queries, qids, the ``single`` lists by backend,
    cells held)."""
    pts = cloud(seed, 96, family, dup_every, zipf_a)
    qpos, qid = queries(pts, 24, seed)
    k = 6
    idx = _index(pts, device)
    singles = {b: _sweep(idx, qpos, qid, k=k, backend=b, plan="single",
                         mesh=None, device=device)
               for b in available_backends()}
    ref = singles["dense_topk"]
    check_oracle(pts, qpos, qid, *ref, k)
    for backend, base in singles.items():
        np.testing.assert_allclose(base[1], ref[1], rtol=1e-6,
                                   err_msg=f"dists {backend} vs dense")
    n_cells = 0
    for backend in backends or available_backends():
        base = singles[backend]
        for plan, mesh, part, merge in list(_cells(merges))[1:]:
            got = _sweep(idx, qpos, qid, k=k, backend=backend, plan=plan,
                         mesh=mesh, partitioner=part, merge=merge,
                         device=device)
            _same(got, base, f"{backend}/{plan}/{part}/{merge}")
            n_cells += 1
    return pts, qpos, qid, singles, n_cells


def mixed_matrix(seed, family, dup_every, zipf_a, *, device, backends=None,
                 merges=("fused_multi",)):
    """``precision="mixed"`` == fp32 ``single``, bitwise, for every backend
    across the whole grid, the object-axis cells under ``merges``.  Returns
    as :func:`full_matrix` (the fp32 ``single`` lists)."""
    pts = cloud(seed, 96, family, dup_every, zipf_a)
    qpos, qid = queries(pts, 24, seed)
    k = 6
    idx = _index(pts, device)
    singles, n_cells = {}, 0
    for backend in backends or available_backends():
        base = _sweep(idx, qpos, qid, k=k, backend=backend, plan="single",
                      mesh=None, device=device)
        singles[backend] = base
        for plan, mesh, part, merge in _cells(merges):
            got = _sweep(idx, qpos, qid, k=k, backend=backend, plan=plan,
                         mesh=mesh, partitioner=part, precision="mixed",
                         merge=merge, device=device)
            _same(got, base, f"mixed {backend}/{plan}/{part}/{merge}")
            n_cells += 1
    return pts, qpos, qid, singles, n_cells


def fewer_objects_than_k(seed, n, dup_every, *, device,
                         backends=("dense_topk",), merges=(None,)):
    """n < k = 8: (-1, inf) padding identical across the grid, including
    object shards that hold only sentinel rows.  Returns (cloud, qids, the
    ``single`` lists by backend, cells held)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    if dup_every > 1:
        pts = np.tile(pts, (1 + n // dup_every, 1))[:n]
    qid = np.arange(n, dtype=np.int32)
    k = 8
    idx = _index(pts, device, l_max=4, th_quad=4)
    singles, n_cells = {}, 0
    for backend in backends:
        base = _sweep(idx, pts, qid, k=k, backend=backend, plan="single",
                      mesh=None, device=device)
        # each query sees the other n-1 objects, then padding
        assert np.isinf(base[1][:, n - 1:]).all(), backend
        assert (base[0][:, n - 1:] == -1).all(), backend
        if singles:
            np.testing.assert_allclose(
                base[1], singles[backends[0]][1], rtol=1e-6,
                err_msg=f"dists {backend} vs {backends[0]}")
        singles[backend] = base
        for plan, mesh, part, merge in list(_cells(merges))[1:]:
            got = _sweep(idx, pts, qid, k=k, backend=backend, plan=plan,
                         mesh=mesh, partitioner=part, merge=merge,
                         device=device)
            _same(got, base, f"{backend}/{plan}/{part}/{merge}")
            n_cells += 1
    return pts, qid, singles, n_cells


def _lockstep(sessions, tag):
    """Submit both sessions; lists and every index field equal bitwise."""
    a, b = sessions["rebuild"], sessions["incremental"]
    ra, rb = a.submit().result(), b.submit().result()
    _same((rb.nn_idx, rb.nn_dist), (ra.nn_idx, ra.nn_dist), tag)
    for f in ("pos", "ids", "codes", "starts", "pyramid", "leaf_level"):
        np.testing.assert_array_equal(
            getattr(a.index, f).cpu().numpy(),
            getattr(b.index, f).cpu().numpy(), err_msg=f"{tag}/{f}")
    return ra, rb


def maintenance_axis(seed, family, dup_every, zipf_a, *, device,
                     backend="dense_topk", merges=(None,), grid=PLAN_GRID):
    """``maintenance="incremental"`` == ``"rebuild"``, bitwise, at every
    tick across the grid: a fresh build (``skip``), a 12-row teleport
    (``incremental``; the per-shard budget may defer it on the object-axis
    plans), a clean tick, a 60% move over the churn budget (``rebuild``),
    and another 12-row teleport.  Lists and every index array each tick,
    on the cells of ``grid``."""
    from .api import KnnSession, ServiceSpec

    n, nq, k = 128, 16, 4
    pts0 = cloud(seed, n, family, dup_every, zipf_a)
    qpos, qid = queries(pts0, nq, seed)
    script = [None, 12, None, int(n * 0.6), 12]
    want_modes = ["skip", "incremental", "skip", "rebuild", "incremental"]
    n_cells = 0
    for plan, mesh, part, merge in _cells(merges, grid):
        sessions = {}
        for maint in ("rebuild", "incremental"):
            spec = ServiceSpec(
                k=k, window=16, chunk=32, l_max=5, th_quad=8, side=SIDE,
                plan=plan, mesh_shape=mesh, partitioner=part,
                maintenance=maint, churn_budget=0.25, delta_pad=16,
                rebuild_factor=1e9, **_spec_kw(backend, merge),
            )
            s = KnnSession(spec, device=device)
            s.ingest_objects(pts0)
            s.register_queries(qpos, qid)
            sessions[maint] = s
        move_rng = np.random.default_rng(seed + 3)
        for t, mv in enumerate(script):
            if mv:
                ids = move_rng.choice(n, mv, replace=False)
                # teleport: Morton ranks and shard ownership change
                new = move_rng.uniform(0, SIDE, (mv, 2)).astype(np.float32)
                for s in sessions.values():
                    s.update_objects(ids, new)
            tag = f"{backend}/{plan}/{part}/{merge}/tick{t}"
            _, rb = _lockstep(sessions, tag)
            if want_modes[t] == "incremental" and _object_axis(plan, mesh) > 1:
                # the per-shard churn budget may defer an in-budget tick
                assert rb.maintenance in ("incremental", "rebuild"), tag
            else:
                assert rb.maintenance == want_modes[t], (tag, rb.maintenance)
        n_cells += 1
    return n_cells


def mover_crosses_boundary(*, device, backend="dense_topk", merge=None):
    """A mover crosses a ``cost_balanced`` object-shard boundary on the
    same tick the boundary moves, and the incremental splice still gives
    the rebuild's bits (``object_sharded`` :data:`NDEV`, 125 objects)."""
    from .api import KnnSession, ServiceSpec

    n, nq, k = 125, 16, 4
    rng = np.random.default_rng(71)
    pts0 = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos, qid = queries(pts0, nq, 71)
    sessions = {}
    for maint in ("rebuild", "incremental"):
        spec = ServiceSpec(
            k=k, window=16, chunk=32, l_max=5, th_quad=8, side=SIDE,
            plan="object_sharded", mesh_shape=NDEV,
            partitioner="cost_balanced", maintenance=maint,
            churn_budget=0.25, delta_pad=16, rebuild_factor=1e9,
            **_spec_kw(backend, merge),
        )
        s = KnnSession(spec, device=device)
        s.ingest_objects(pts0)
        s.register_queries(qpos, qid)
        sessions[maint] = s
    b = sessions["incremental"]
    _lockstep(sessions, "tick0")
    by_rank0 = b.index.ids.cpu().numpy().copy()
    mover = int(by_rank0[0])  # lowest Morton rank
    bounds0 = b._obj_bounds.cpu().numpy().copy()
    src_shard = int(b.object_shards([mover])[0])
    # the boundaries really are the cost seed's, not the capacity rule's
    assert not np.array_equal(bounds0, equal_boundaries(n, NDEV).numpy()), \
        "cost_balanced bounds degenerate to the capacity rule"
    # per source shard, exactly floor(0.25 * owned) movers from its lowest
    # ranks: in budget by construction
    picks = []
    for r in range(len(bounds0) - 1):
        lo, hi = int(bounds0[r]), int(bounds0[r + 1])
        picks.extend(range(lo, lo + (hi - lo) // 4))
    ids = by_rank0[np.asarray(picks, np.int64)]
    assert mover in ids
    # one tight hotspot at the far (max-Morton) corner: every shard's ranks
    # shift, so the object each boundary starts at moves this tick
    hot = np.array([SIDE * 0.993, SIDE * 0.987], np.float32)
    new = (hot + rng.normal(0, SIDE * 1e-4, (len(ids), 2))).astype(np.float32)
    for s in sessions.values():
        s.update_objects(ids, new)
    _, rb1 = _lockstep(sessions, "tick1-crossing")
    assert rb1.maintenance == "incremental"
    assert int(b.object_shards([mover])[0]) != src_shard, \
        "mover did not cross a shard boundary"
    by_rank1 = b.index.ids.cpu().numpy()
    cut = int(bounds0[src_shard + 1])
    assert by_rank1[cut] != by_rank0[cut], "boundary object did not move"
    # settle: a clean tick replays the same bits off the spliced order
    _, rb2 = _lockstep(sessions, "tick2-clean")
    assert rb2.maintenance == "skip"
    return 3


def server_axis(seed, family, dup_every, zipf_a, *, device,
                backend="dense_topk", merges=(None,), grid=PLAN_GRID):
    """A 3-tenant ``KnnServer`` == 3 solo sessions, bitwise, at every tick
    on the cells of ``grid``, under both invalidations: tick 0 computes,
    tick 1 (no motion) replays wholly from the cache (no computed row),
    tick 2 follows a 16-object delta fed through one tenant."""
    from .api import KnnSession, ServiceSpec
    from .serve import KnnServer

    n, rows, k = 128, 8, 4
    pts = cloud(seed, n, family, dup_every, zipf_a)
    rng = np.random.default_rng(seed + 5)
    shared, _ = queries(pts, rows // 2, seed)  # exact-duplicate prefix
    tq = []
    for g in range(3):
        own = rng.uniform(0, SIDE, (rows - shared.shape[0], 2)).astype(
            np.float32)
        qid = np.full((rows,), -2, np.int32)
        qid[-1] = g
        tq.append((np.concatenate([shared, own]), qid))
    ids = rng.choice(n, 16, replace=False).astype(np.int32)
    new = rng.uniform(0, SIDE, (16, 2)).astype(np.float32)
    n_cells = 0
    for plan, mesh, part, merge in _cells(merges, grid):
        spec = ServiceSpec(k=k, window=16, chunk=32, l_max=5, th_quad=8,
                           side=SIDE, plan=plan, mesh_shape=mesh,
                           partitioner=part, **_spec_kw(backend, merge))
        got = {}
        for invalidation in ("epoch", "spatial"):
            srv = KnnServer(spec, invalidation=invalidation, device=device)
            srv.ingest_objects(pts)
            tenants = [srv.admit(f"t{g}") for g in range(3)]
            handles = [t.register_queries(*tq[g])
                       for g, t in enumerate(tenants)]
            ticks = []
            for t in range(3):
                if t == 2:
                    tenants[1].update_objects(ids, new)
                tick = srv.submit()
                res = tick.result()
                if t == 1:  # unchanged world: full cache replay
                    assert res.rows_computed == 0, (
                        plan, part, merge, invalidation, res)
                ticks.append([tick.result_for(h) for h in handles])
            got[invalidation] = ticks
        for g, (qpos, qid) in enumerate(tq):
            sess = KnnSession(spec, device=device)
            sess.ingest_objects(pts)
            sess.register_queries(qpos, qid)
            want = [sess.submit().result()]
            sess.update_objects(ids, new)
            want.append(sess.submit().result())
            for inval, ticks in got.items():
                for srv_t, solo_t in ((0, 0), (1, 0), (2, 1)):
                    _same(ticks[srv_t][g][:2],
                          (want[solo_t].nn_idx, want[solo_t].nn_dist),
                          f"{backend}/{plan}/{part}/{merge}/{inval}/t{g}/"
                          f"tick{srv_t}")
        n_cells += 1
    return n_cells


def r_way_partition(r: int, *, device, backend="dense_topk",
                    merge="dense_merge"):
    """The object-axis composition law without a plan: R local quadtrees
    over the equal partition's Morton-contiguous slices (89 objects, so the
    last slice is short; positions duplicated), each swept whole, merged by
    ``tree_merge_lists``, equal to the ``single`` plan's bits."""
    dev = resolve_device(device)
    rng = np.random.default_rng(40 + r)
    base = rng.uniform(0, SIDE, (45, 2)).astype(np.float32)
    pts = np.tile(base, (2, 1))[:89]
    pts = pts[rng.permutation(len(pts))]
    qpos, qid = queries(pts, 24, seed=7)
    k, window, chunk = 6, 16, 16
    idx = _index(pts, dev)
    want = knn_query_batch_chunked(idx, qpos, qid, k=k, window=window,
                                   chunk=chunk, plan="single",
                                   backend=backend, device=dev)[:2]

    nq, n = qpos.shape[0], pts.shape[0]
    qpos_p, qid_p = plan_mod.pad_queries(qpos, qid, chunk)
    qpos_t = torch.tensor(qpos_p, device=dev)
    order, inv = _sort_unsort(idx, qpos_t)
    qs = qpos_t[order]
    qi = torch.tensor(qid_p, device=dev)[order]
    part = resolve_partitioner("equal")
    cap = part.object_capacity(n, r)
    assert cap == object_shard_capacity(n, r)
    bounds = part.object_boundaries(plan_mod._object_row_costs(idx), r)
    bounds = bounds.tolist()
    assert bounds == [min(s * cap, n) for s in range(r + 1)], bounds
    opos, oids, ocodes = plan_mod._pad_object_tail(idx, cap)
    parts_d, parts_i = [], []
    for s in range(r):
        local = plan_mod._shard_local_index(
            idx, opos, oids, ocodes, bounds[s], bounds[s + 1] - bounds[s],
            cap, "rebuild")
        ii, d2, _, _ = plan_mod._chunked_sweep(
            local, qs, qi, k=k, window=window, chunk=chunk,
            max_nav=_resolve_max_nav(idx, None), max_iters=100_000,
            executor=resolve_executor(backend))
        parts_d.append(d2)
        parts_i.append(ii)
    got_d2, got_i = tree_merge_lists(torch.stack(parts_d),
                                     torch.stack(parts_i), k=k, merge=merge)
    got = (got_i[inv][:nq].cpu().numpy(), sqrt(got_d2[inv])[:nq].cpu().numpy())
    _same(got, want, f"r={r} {backend}/{merge}")
    return 1
