"""Parity: the port's serving layer (``repro_torch.serve``) against the JAX
package's, and the port's ``knn`` entry point.

* ``ball_stab_mask``: the port's copy against the reference's on seeded and
  edge inputs (exact ties on a ball's boundary, r = 0, NaN / inf centres and
  radii, -0, points outside the region), in both regimes; masks bitwise.
* The numpy layers (registry, cache, tenants) driven through the same
  operations as the reference's: the same keys, LRU and epoch state,
  admissions, quota errors and evictions.
* A torch ``KnnServer`` against the JAX ``KnnServer`` on the ``single``
  plan over one scripted run, under ``invalidation="epoch"`` and
  ``"spatial"``: every tenant's rows and every tick counter bitwise.
* The torch server on the object-axis plans against torch solo sessions,
  row for row, and under ``collect="stats"`` (device rows, no cache).
"""
import numpy as np
import pytest
import torch

from repro.api import KnnSession as JaxSession
from repro.api import ServiceSpec as JaxSpec
from repro.core.quadtree import ball_stab_mask as jax_stab
from repro.serve import AdmissionError as JaxAdmissionError
from repro.serve import KnnServer as JaxServer
from repro.serve import QuotaExceededError as JaxQuotaError
from repro.serve import ResultCache as JaxCache
from repro.serve import TenantRegistry as JaxRegistry
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.core.quadtree import ball_stab_mask
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import (
    AdmissionError,
    KnnServer,
    QuotaExceededError,
    ResultCache,
    TenantRegistry,
)

torch.set_num_threads(2)

SIDE = 1000.0
COUNTERS = ("rows_total", "rows_unique", "rows_computed", "dedup_hit_rows",
            "cache_hit_rows", "epoch", "rebuilt")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(a, b, msg=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=msg)


# ------------------------------------------------------------ ball stab

def _stab_edges():
    """Balls and moved points on every edge the stab has to get right."""
    centers = np.array([
        [100.0, 100.0],   # a moved point exactly on the boundary (3-4-5)
        [200.0, 200.0],   # r = 0, a moved point bitwise at the centre
        [250.0, 250.0],   # r = 0, nothing at the centre
        [np.nan, 5.0],    # NaN centre
        [np.inf, 3.0],    # inf centre
        [-0.0, 0.0],      # -0 centre, r = 0, a moved +0 point
        [400.0, 400.0],   # NaN radius
        [600.0, 600.0],   # inf radius (fewer than k candidates)
        [999.0, 999.0],   # near the far corner, a moved point outside
        [700.0, 100.0],   # just missed: the boundary point plus 1e-3
        [10.0, 990.0],    # far from everything
    ], np.float32)
    kth2 = np.array([25.0, 0.0, 0.0, 1.0, 1.0, 0.0, np.nan, np.inf, 4.0,
                     25.0, 9.0])
    moved = np.array([
        [103.0, 104.0], [200.0, 200.0], [0.0, 0.0], [1000.5, 1000.0],
        [703.0, 104.001], [-5.0, -5.0], [1500.0, 20.0], [-0.0, -0.0],
    ], np.float32)
    return centers, kth2, moved


def _stab_random(seed, e=400, m=120):
    g = np.random.default_rng(seed)
    centers = g.uniform(-20, SIDE + 20, (e, 2)).astype(np.float32)
    kth2 = (g.uniform(0, 60, e) ** 2).astype(np.float32).astype(np.float64)
    moved = g.uniform(-20, SIDE + 20, (m, 2)).astype(np.float32)
    return centers, kth2, moved


@pytest.mark.parametrize("exact_rows", [0, 64, 10_000])
@pytest.mark.parametrize("case", ["edges", "random", "empty_moved",
                                  "no_entries"])
def test_ball_stab_mask_matches_jax(case, exact_rows):
    """Both regimes on the same inputs: exact_rows 0 takes the pyramid,
    10,000 the exact check, 64 whichever the input's size selects."""
    if case in ("edges", "empty_moved"):
        centers, kth2, moved = _stab_edges()
        if case == "empty_moved":
            moved = moved[:0]
    else:
        centers, kth2, moved = _stab_random(5)
        if case == "no_entries":
            centers, kth2 = centers[:0], kth2[:0]
    for l_max in (5, 8):
        kw = dict(origin=np.array([0.0, 0.0]), side=SIDE, l_max=l_max,
                  exact_rows=exact_rows)
        want = jax_stab(centers, kth2, moved, **kw)
        got = ball_stab_mask(centers, kth2, moved, **kw)
        assert got.dtype == want.dtype == bool
        _same(want, got, f"l_max={l_max}")
    if case == "edges" and exact_rows == 10_000:
        # the exact regime: ties and r = 0 stab, the near miss does not
        assert got[[0, 1, 3, 4, 5, 6, 7, 8]].all()
        assert not got[[2, 9, 10]].any()


# ------------------------------------------------------- numpy layers

def _keys_rows(reg):
    view = reg.compute_view()
    return view.keys, view.row_to_unique, view.qpos, view.qid


def test_registry_keys_match_jax():
    """Dedup by raw bits: -0 and +0, and two NaN payloads, are distinct
    keys; the same groups give the same keys, rows and order."""
    nan_a = np.array([0x7FC00000], np.uint32).view(np.float32)[0]
    nan_b = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    base = np.random.default_rng(1).uniform(0, SIDE, (6, 2)).astype(
        np.float32)
    groups = [
        (0, base, None),
        (1, base[:3], None),  # duplicates of tenant 0's rows
        (1, base[:2], np.array([4, -2], np.int32)),  # qid is part of the key
        (2, np.array([[0.0, 1.0], [-0.0, 1.0], [nan_a, 2.0], [nan_b, 2.0]],
                     np.float32), None),
    ]
    regs = (JaxRegistry(), TenantRegistry())
    hids = [[r.register(t, q, i) for (t, q, i) in groups] for r in regs]
    assert hids[0] == hids[1]
    for a, b in zip(_keys_rows(regs[0]), _keys_rows(regs[1])):
        if isinstance(a, list):
            assert a == b
        else:
            _same(a, b)
    # one new key from the qid, four from the zeros and NaN payloads
    assert regs[1].compute_view().n_unique == 6 + 1 + 4
    for r in regs:
        r.update(hids[0][1], base[3:6])
        r.drop(hids[0][0])
        r.drop_tenant(2)
    assert _keys_rows(regs[0])[0] == _keys_rows(regs[1])[0]
    for r in regs:
        with pytest.raises(KeyError, match="not live"):
            r.drop(hids[0][0])
        with pytest.raises(ValueError, match="owns 3 rows"):
            r.update(hids[0][1], base[:2])


def test_result_cache_matches_jax():
    """The same inserts, lookups, LRU pressure, stab evictions and epoch
    bumps leave the same store, geometry and counters."""
    caches = (JaxCache(capacity=3), ResultCache(capacity=3))
    ii = np.arange(4, dtype=np.int32)
    dd = np.arange(4, dtype=np.float32)
    trace = []
    for c in caches:
        out = []
        out.append(c.lookup(b"a") is None)
        c.insert(b"a", ii, dd, center=np.array([1.0, 2.0], np.float32),
                 kth_dist=np.float32(1.5))
        c.insert(b"b", ii + 1, dd)
        c.insert(b"c", ii, dd + 1, center=np.array([3.0, 4.0], np.float32),
                 kth_dist=np.float32(0.25))
        got = c.lookup(b"a")
        out.append(not got[0].flags.writeable)
        c.insert(b"d", ii, dd)  # evicts "b", the least recently used
        out.append(c.lookup(b"b") is None)
        keys, centers, kth2 = c.geometry()
        out.append((keys, _bits(centers).tolist(), kth2.tolist()))
        out.append(c.evict_keys([b"c", b"zz"], "stab"))
        c.bump_mutation()
        out.append((c.mutation, c.epoch, len(c), c.last_invalidation))
        c.bump_epoch("snapshot")
        out.append((c.epoch, len(c), c.last_invalidation,
                    c.stats.as_dict()))
        trace.append(out)
    assert repr(trace[0]) == repr(trace[1])
    off = ResultCache(capacity=0)
    off.insert(b"a", ii, dd)
    assert not off.enabled and off.lookup(b"a") is None
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=-1)


def _spec_kw(**over):
    kw = dict(k=8, window=32, chunk=256, l_max=5, th_quad=16, side=SIDE,
              backend="dense_topk", rebuild_factor=1.5, delta_pad=64)
    kw.update(over)
    return kw


def _servers(server_kw=None, **spec_over):
    kw = _spec_kw(**spec_over)
    server_kw = server_kw or {}
    return (JaxServer(JaxSpec(**kw), **server_kw),
            KnnServer(ServiceSpec(**kw), device="cpu", **server_kw))


def _admission_script(srv, adm_err, quota_err):
    """Admissions, quotas and an eviction; returns what each step did."""
    g = np.random.default_rng(3)
    out = []
    a = srv.admit("alice")
    try:
        srv.admit("alice")
    except adm_err as e:
        out.append(("dup", "already admitted" in str(e)))
    b = srv.admit("bob", quota=5)
    try:
        srv.admit("carol")
    except adm_err as e:
        out.append(("full", "max_tenants" in str(e)))
    srv.ingest_objects(g.uniform(0, SIDE, (200, 2)).astype(np.float32))
    q = g.uniform(0, SIDE, (8, 2)).astype(np.float32)
    a.register_queries(q[:4])
    try:
        b.register_queries(q)
    except quota_err as e:
        out.append(("quota", "exceed quota 5" in str(e)))
    h = b.register_queries(q, clip=True)
    out.append(("clip", h.count, b.quota_remaining, srv.query_count))
    try:
        b.register_queries(q[:1], clip=True)
    except quota_err:
        out.append(("clip at zero", True))
    res = srv.submit().result()
    out.append(tuple(getattr(res, f) for f in COUNTERS))
    srv.evict(a)
    out.append(("evicted", a.live, srv.query_count, srv.tenants))
    try:
        a.register_queries(q[:1])
    except adm_err as e:
        out.append(("dead", "evicted" in str(e)))
    try:
        srv.evict(a)
    except adm_err as e:
        out.append(("twice", "not admitted" in str(e)))
    try:
        srv.admit("dave", quota=0)
    except ValueError as e:
        out.append(("quota 0", "quota must be >= 1" in str(e)))
    srv.admit("carol")  # the freed slot readmits
    res = srv.submit().result()  # bob's rows only, from the cache
    out.append(tuple(getattr(res, f) for f in COUNTERS))
    return out


def test_admission_quota_eviction_match_jax():
    js, ts = _servers(dict(max_tenants=2))
    want = _admission_script(js, JaxAdmissionError, JaxQuotaError)
    got = _admission_script(ts, AdmissionError, QuotaExceededError)
    assert want == got
    assert ("clip", 5, 0, 9) in got and len(got) == 11  # every branch ran


# ------------------------------------------------ server against the JAX one

def _tenant_rows(g, pos, n_shared=16, n_own=12):
    """Three tenants' queries: rows every tenant shares (at objects, each
    excluding its own object), then rows of their own."""
    shared = np.arange(n_shared, dtype=np.int32)
    out = []
    for t in range(3):
        own = g.uniform(0, SIDE, (n_own, 2)).astype(np.float32)
        qpos = np.concatenate([pos[shared], own])
        qid = np.concatenate([shared, np.full((n_own,), -2, np.int32)])
        out.append((qpos, qid))
    return out


def _drive(srv, n, seed):
    """One scripted run; returns per tick the counters and every live
    tenant group's rows.

    Ticks: the build; an unchanged tick (all from the cache); a 3-row delta
    (the exact stab), a 10-row delta (the pyramid stab, under the budget),
    a 30-row delta (over it: the epoch clear); a teleport of every object
    into one cluster whose tick is still in flight when another tenant
    feeds a 3-row delta and submits (the drift rebuild, mid-flight); an
    eviction; an unchanged tick.
    """
    g = np.random.default_rng(seed)
    pos = g.uniform(0, SIDE, (n, 2)).astype(np.float32)
    clustered = (g.normal(0, 25, (n, 2)) + SIDE / 2).astype(
        np.float32).clip(0, SIDE - 1)
    srv.ingest_objects(pos)
    tenants = [srv.admit(name) for name in ("alice", "bob", "carol")]
    groups = [t.register_queries(*q)
              for t, q in zip(tenants, _tenant_rows(g, pos))]

    def delta(m):
        ids = g.choice(n, m, replace=False).astype(np.int32)
        return ids, (pos[ids] + g.uniform(-15, 15, (m, 2))).clip(
            0, SIDE - 1).astype(np.float32)

    ticks = []

    def read(st, live):
        res = st.result()
        rows = [tuple(_bits(np.asarray(a)) for a in st.result_for(h))
                for h, ok in zip(groups, live) if ok]
        ticks.append((tuple(getattr(res, f) for f in COUNTERS),
                      res.inner is None, rows))

    live = [True, True, True]
    for t, step in enumerate((None, None, 3, 10, 30)):
        if step:
            tenants[t % 3].update_objects(*delta(step))
        read(srv.submit(), live)
    tenants[1].update_objects(np.arange(n, dtype=np.int32), clustered)
    st_drift = srv.submit()
    tenants[0].update_objects(*delta(3))
    st_next = srv.submit()
    read(st_drift, live)
    read(st_next, live)
    srv.evict(tenants[2])
    live[2] = False
    read(srv.submit(), live)
    read(srv.submit(), live)
    return ticks


@pytest.mark.parametrize("invalidation", ["epoch", "spatial"])
@pytest.mark.parametrize("backend,n", [("dense_topk", 600),
                                       ("fused_bucket", 300)])
def test_server_matches_jax(backend, n, invalidation):
    """Every tenant's rows and every tick counter of the torch server equal
    the JAX server's, bit for bit, over the scripted run of :func:`_drive`."""
    kw = dict(invalidation=invalidation, stab_budget=24, stab_exact_rows=8)
    js, ts = _servers(kw, backend=backend, l_max=6)
    want, got = _drive(js, n, 21), _drive(ts, n, 21)
    assert len(want) == len(got) == 9
    for t, (w, o) in enumerate(zip(want, got)):
        assert w[0] == o[0] and w[1] == o[1], (t, w[0], o[0])
        assert len(w[2]) == len(o[2])
        for wr, orow in zip(w[2], o[2]):
            for a, b in zip(wr, orow):
                _same(a, b, f"tick {t}")
    counters = [o[0] for o in got]
    pure = [o[1] for o in got]
    assert pure[1] and pure[-1]  # the unchanged ticks dispatch nothing
    assert counters[5][-1], "the teleport tick did not rebuild"
    if invalidation == "spatial":
        # the small deltas recompute only what they stab
        assert 0 < counters[2][2] < counters[2][1]
        assert counters[4][2] == counters[4][1]  # over budget: all of it


# ------------------------------------- composition on the object-axis plans

@pytest.mark.parametrize("collect", ["full", "stats"])
@pytest.mark.parametrize("plan,mesh,part", [
    ("object_sharded", 4, "equal"), ("hybrid", (2, 3), "cost_balanced")])
def test_server_equals_solo_sessions(plan, mesh, part, collect):
    """Three overlapping tenants through one torch server equal three torch
    solo sessions row for row, over a build, an unchanged tick and a delta;
    under ``collect="stats"`` the rows come back as device tensors and no
    row comes from the cache."""
    n = 500
    kw = _spec_kw(plan=plan, mesh_shape=mesh, partitioner=part)
    g = np.random.default_rng(31)
    pos = g.uniform(0, SIDE, (n, 2)).astype(np.float32)
    tq = _tenant_rows(g, pos)
    ids = g.choice(n, 25, replace=False).astype(np.int32)
    new = g.uniform(0, SIDE, (ids.size, 2)).astype(np.float32)
    srv = KnnServer(ServiceSpec(collect=collect, **kw), device="cpu",
                    invalidation="spatial")
    assert srv.cache.enabled == (collect == "full")
    srv.ingest_objects(pos)
    tenants = [srv.admit(f"t{i}") for i in range(3)]
    groups = [t.register_queries(*q) for t, q in zip(tenants, tq)]
    rows = []
    for t in range(3):
        if t == 2:
            tenants[1].update_objects(ids, new)
        st = srv.submit()
        res = st.result()
        if collect == "stats":
            assert res.cache_hit_rows == 0 and res.inner is not None
            assert res.inner.aggregates is not None
        rows.append([st.result_for(h) for h in groups])
        if collect == "stats":
            assert all(torch.is_tensor(r[0]) for r in rows[-1])
    for i, (qpos, qid) in enumerate(tq):
        solo = KnnSession(ServiceSpec(**kw), device="cpu")
        solo.ingest_objects(pos)
        solo.register_queries(qpos, qid)
        want = [solo.submit().result()]
        solo.update_objects(ids, new)
        want.append(solo.submit().result())
        for srv_t, solo_t in ((0, 0), (1, 0), (2, 1)):
            ii, dd, qids = rows[srv_t][i]
            _same(want[solo_t].nn_idx, np.asarray(ii), f"t{i} tick{srv_t}")
            _same(want[solo_t].nn_dist, np.asarray(dd), f"t{i} tick{srv_t}")
            _same(qid, qids)


# -------------------------------------------------------- the entry point

@pytest.mark.parametrize("tenants", ["1", "2"])
def test_knn_entry_point_runs_on_cpu(tenants, capsys):
    argv = ["knn", "--device", "cpu", "--objects", "1500", "--ticks", "2",
            "--k", "8", "--chunk", "512", "--l-max", "5", "--th-quad", "16",
            "--tenants", tenants]
    assert serve_main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("[knn] tick") == 2
