"""Parity: the port's incremental index maintenance against the JAX reference.

Every comparison is bitwise (``np.array_equal`` on the raw bits, tolerance
0), on inputs made from a seed with numpy and handed to both packages:

* the delta-splice primitives (``kernels/delta_splice.py``) against their
  JAX counterparts, code ties and sentinel rows included;
* ``pyramid_delta`` and ``reindex_objects_delta`` in both key branches (one
  packed int32 key where ``4**l_max * (n+1) + n < 2**31``, the pair keys
  otherwise), each against its own JAX branch and against the JAX full
  ``reindex_objects``, also over chained ticks;
* the per-shard churn accounting (``delta_shard_counts``,
  ``shard_churn_over_budget``) at its exact boundary;
* the session: its maintenance mode per tick, its lists and its index
  against the JAX session, under duplicate ids, a snapshot ingest, churn at
  exactly the budget, a drift rebuild, and per-shard deferral on an
  object-axis plan (the port lays its shards on one device; the JAX
  reference needs a device per shard, so there the port is held against the
  JAX rule and the JAX single-plan session).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KnnSession as JaxSession
from repro.api import ServiceSpec as JaxSpec
from repro.core import quadtree as jq
from repro.core import ticks as jt
from repro.kernels import delta_splice as jds
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.api import session as tsession
from repro_torch.core import quadtree as tq
from repro_torch.core import ticks as tt
from repro_torch.kernels import delta_splice as tds

torch.set_num_threads(2)

SIDE = 1000.0
FIELDS = ("pos", "ids", "codes", "starts", "pyramid", "leaf_level")


def _bits(x):
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal(want, got, what=""):
    a, b = _bits(want), _bits(got)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _index_equal(a, b, fields=FIELDS):
    for f in fields:
        _equal(getattr(a, f), getattr(b, f), f)


def _t(a):
    return torch.tensor(np.asarray(a))


def _indexes(pts, l_max=5, th=8):
    origin = np.zeros(2, np.float32)
    return (jq.build_index(jnp.asarray(pts), jnp.asarray(origin), SIDE,
                           l_max=l_max, th_quad=th),
            tq.build_index(_t(pts), _t(origin), SIDE, l_max=l_max,
                           th_quad=th))


def _sorted_run(rng, n, alphabet, ids):
    """(codes, ids) ascending by (code, id), codes from a small alphabet."""
    codes = rng.integers(0, alphabet, n).astype(np.int32)
    order = np.lexsort((ids, codes))
    return codes[order], ids[order]


# --------------------------------------------------------- delta splice
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [1, 200, 1025])
def test_searchsorted_pairs_matches_jax(side, n):
    rng = np.random.default_rng(n)
    kc, ki = _sorted_run(rng, n, 50, rng.integers(0, 1000, n).astype(np.int32))
    qc = rng.integers(-1, 51, 300).astype(np.int32)
    qi = rng.integers(-1, 1001, 300).astype(np.int32)
    qc[:50], qi[:50] = kc[rng.integers(0, n, 50)], ki[rng.integers(0, n, 50)]
    want = jds.searchsorted_pairs(jnp.asarray(kc), jnp.asarray(ki),
                                  jnp.asarray(qc), jnp.asarray(qi), side=side)
    got = tds.searchsorted_pairs(_t(kc), _t(ki), _t(qc), _t(qi), side=side)
    _equal(want, got)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("na,nb", [(17, 5), (64, 64), (1, 33)])
def test_merge_ranks_and_splice_payload_match_jax(seed, na, nb):
    """Cross-run code ties (a six-code alphabet), unique ids, sentinel rows
    equal across both runs, a 1-D and a 2-D payload."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(na + nb).astype(np.int32)
    ca, ia = _sorted_run(rng, na, 6, ids[:na])
    cb, ib = _sorted_run(rng, nb, 6, ids[na:])
    sent_c, sent_i = np.int32(1 << 10), np.int32(na + nb)
    ca = np.concatenate([ca, [sent_c, sent_c]]).astype(np.int32)
    ia = np.concatenate([ia, [sent_i, sent_i]]).astype(np.int32)
    cb = np.concatenate([cb, [sent_c]]).astype(np.int32)
    ib = np.concatenate([ib, [sent_i]]).astype(np.int32)
    want = jds.merge_ranks(*(jnp.asarray(a) for a in (ca, ia, cb, ib)))
    got = tds.merge_ranks(*(_t(a) for a in (ca, ia, cb, ib)))
    for w, g in zip(want, got):
        _equal(w, g)
    va = rng.uniform(0, 1, (ca.size, 2)).astype(np.float32)
    vb = rng.uniform(0, 1, (cb.size, 2)).astype(np.float32)
    for a, b in ((ia, ib), (va, vb)):
        _equal(jds.splice_payload(*want, jnp.asarray(a), jnp.asarray(b),
                                  na + nb, fill=-1),
               tds.splice_payload(*got, _t(a), _t(b), na + nb, fill=-1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_splice_plan_and_gather_match_jax(seed):
    """The gather plan and both payloads, with heavy code ties and
    sentinel padding on both event arrays."""
    rng = np.random.default_rng(seed)
    n, d, npad = 120, 30, 9
    sent_c, sent_i = np.int32(1 << 12), np.int32(n)
    codes, ids = _sorted_run(rng, n, 12, rng.permutation(n).astype(np.int32))
    slots_real = np.sort(rng.choice(n, d, replace=False)).astype(np.int32)
    new_codes = rng.integers(0, 12, d).astype(np.int32)
    ord_b = np.lexsort((ids[slots_real], new_codes))
    cb = np.concatenate([new_codes[ord_b], np.full(npad, sent_c)])
    ib = np.concatenate([ids[slots_real][ord_b], np.full(npad, sent_i)])
    packed = codes.astype(np.int64) * (1 << 13) + ids
    ins_full = np.searchsorted(packed, cb.astype(np.int64) * (1 << 13) + ib,
                               side="right").astype(np.int32)
    slots = np.concatenate([slots_real, np.full(npad, n, np.int32)])
    want = jds.sparse_splice_plan(jnp.asarray(slots), jnp.asarray(ins_full), n)
    got = tds.sparse_splice_plan(_t(slots), _t(ins_full), n)
    for w, g in zip(want, got):
        _equal(w, g)
    pay = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    pay_b = rng.uniform(0, 1, (d + npad, 2)).astype(np.float32)
    for a, b in ((ids, ib), (pay, pay_b)):
        _equal(jds.gather_splice(*want, jnp.asarray(a), jnp.asarray(b)),
               tds.gather_splice(*got, _t(a), _t(b)))


# ----------------------------------------------------------------- core
@pytest.mark.parametrize("l_max", [3, 5])
def test_pyramid_delta_matches_jax(l_max):
    """+-weight at the old and new fine cells, zero-weight padding rows and
    sentinel codes (4**l_max) that fall out of the pyramid."""
    rng = np.random.default_rng(4 + l_max)
    codes = rng.integers(0, 4**l_max, 500).astype(np.int32)
    pyr = jq._count_pyramid(jnp.asarray(codes), l_max)
    moved = rng.choice(500, 60, replace=False)
    new = rng.integers(0, 4**l_max, 60).astype(np.int32)
    sent = np.int32(4**l_max)
    old = np.concatenate([codes[moved], [0, 1, sent, sent]]).astype(np.int32)
    new = np.concatenate([new, [3, 2, sent, 5]]).astype(np.int32)
    w = np.concatenate([np.ones(60), np.zeros(2), np.ones(2)]).astype(np.int32)
    w[-1] = 0
    want = jq.pyramid_delta(pyr, jnp.asarray(old), jnp.asarray(new),
                            jnp.asarray(w), l_max)
    got = tq.pyramid_delta(_t(np.asarray(pyr)), _t(old), _t(new), _t(w),
                           l_max)
    _equal(want, got)


def _delta_case(n, d, seed, l_max):
    """Points, a moved copy and the padded delta: coincident points, same
    cell nudges, no-op moves, sentinel rows with arbitrary old positions."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    pts[::7] = pts[3]  # coincident points: code ties
    ids = rng.choice(n, d, replace=False).astype(np.int32)
    pts2 = pts.copy()
    pts2[ids] = rng.uniform(0, SIDE, (d, 2)).astype(np.float32)
    pts2[ids[: d // 4]] = pts[ids[: d // 4]] + 0.01  # same-cell nudge
    pts2[ids[d // 4: d // 2]] = pts[ids[d // 4: d // 2]]  # no-op move
    padded = np.concatenate([ids, np.full(7, n, np.int32)])
    old = np.concatenate([pts[ids],
                          rng.uniform(0, SIDE, (7, 2)).astype(np.float32)])
    return pts, pts2, padded, old


# (n, l_max): the packed int32 key, and the pair keys (4**10 * 4097 > 2**31)
_BRANCHES = {"packed": (4000, 5), "pair": (4096, 10)}


@pytest.mark.parametrize("frac", [0.001, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("branch", ["packed", "pair"])
def test_reindex_objects_delta_matches_jax(branch, frac):
    n, l_max = _BRANCHES[branch]
    packs = 4**l_max * (n + 1) + n < 2**31
    assert packs == (branch == "packed")
    d = max(1, int(n * frac))
    pts, pts2, padded, old = _delta_case(n, d, seed=d, l_max=l_max)
    jidx, tidx = _indexes(pts, l_max=l_max, th=16)
    want = jq.reindex_objects_delta(jidx, jnp.asarray(pts2),
                                    jnp.asarray(padded), jnp.asarray(old))
    got = tq.reindex_objects_delta(tidx, _t(pts2), _t(padded), _t(old))
    _index_equal(want, got)
    _index_equal(jq.reindex_objects(jidx, jnp.asarray(pts2)), got)


@pytest.mark.parametrize("branch", ["packed", "pair"])
def test_reindex_delta_chained_ticks_match_jax(branch):
    """Five ticks, each feeding the port's spliced index into the next,
    stay on the JAX full-reindex trajectory and equal the JAX splice."""
    n, l_max = _BRANCHES[branch]
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    jfull, tinc = _indexes(pts, l_max=l_max, th=16)
    jinc = jfull
    for _ in range(5):
        ids = rng.choice(n, 31, replace=False).astype(np.int32)
        old = pts[ids].copy()
        pts[ids] = np.clip(pts[ids] + rng.normal(0, SIDE / 10, (31, 2)), 0,
                           SIDE - 0.01).astype(np.float32)
        tinc = tq.reindex_objects_delta(tinc, _t(pts), _t(ids), _t(old))
        jinc = jq.reindex_objects_delta(jinc, jnp.asarray(pts),
                                        jnp.asarray(ids), jnp.asarray(old))
        jfull = jq.reindex_objects(jfull, jnp.asarray(pts))
        _index_equal(jfull, tinc)
        _index_equal(jinc, tinc)


@pytest.mark.parametrize("r,bounds", [(8, None), (4, [0, 30, 101, 101, 257]),
                                      (3, None)])
def test_delta_shard_counts_matches_jax(r, bounds):
    """Counts per source shard under the capacity rule and explicit
    boundaries (an empty shard); sentinel rows count nowhere."""
    rng = np.random.default_rng(13 + r)
    n = 257
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    jidx, tidx = _indexes(pts)
    ids = np.concatenate([rng.choice(n, 40, replace=False),
                          np.full(9, n)]).astype(np.int32)
    jb = None if bounds is None else jnp.asarray(bounds, jnp.int32)
    tb = None if bounds is None else torch.tensor(bounds, dtype=torch.int32)
    _equal(jt.delta_shard_counts(jidx, jnp.asarray(ids), r, jb),
           tt.delta_shard_counts(tidx, _t(ids), r, tb))


@pytest.mark.parametrize("ranks,budget,want", [
    (range(4), 0.25, False),          # shard 0 at exactly its budget
    (range(5), 0.25, True),           # one past: defer
    ([0, 1, 2, 3, 16], 0.25, False),  # the same five spread over two
    (range(3), 0.1875, False),        # 0.1875 * 16 = 3 exactly in f32
    (range(4), 0.1875, True),
    (range(2), 0.1, True),            # f32(0.1) * 16 = 1.6: two is over
])
def test_shard_churn_over_budget_matches_jax(ranks, budget, want):
    """The per-shard rule is strict, in f32 with the f32 product
    budget * owned; sentinel padding rows are inert."""
    rng = np.random.default_rng(14)
    n, r = 64, 4  # the equal rule: 16 owned rows a shard
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    jidx, tidx = _indexes(pts)
    by_rank = np.asarray(jidx.ids).astype(np.int32)
    ids = np.concatenate([by_rank[np.asarray(list(ranks))],
                          np.full(6, n, np.int32)])
    got = tt.shard_churn_over_budget(tidx, _t(ids), r, budget)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == bool(jt.shard_churn_over_budget(
        jidx, jnp.asarray(ids), r, budget))


# -------------------------------------------------------------- session
def _pair(pts, qpos, maintenance, **over):
    kw = dict(k=4, chunk=256, window=32, l_max=5, th_quad=32, side=SIDE,
              delta_pad=64, maintenance=maintenance, backend="dense_topk")
    kw.update(over)
    out = []
    for s in (JaxSession(JaxSpec(**kw)),
              KnnSession(ServiceSpec(**kw), device="cpu")):
        s.ingest_objects(pts)
        s.register_queries(qpos)
        out.append(s)
    return out


def _same_tick(js, ts):
    """Submit both, hold lists, counters, the mode and the index bitwise."""
    rj, rt = js.submit().result(), ts.submit().result()
    _equal(rj.nn_idx, rt.nn_idx, "nn_idx")
    _equal(rj.nn_dist, rt.nn_dist, "nn_dist")
    assert (rj.iterations, rj.candidates, rj.rebuilt, rj.maintenance) == (
        rt.iterations, rt.candidates, rt.rebuilt, rt.maintenance)
    _index_equal(js.index, ts.index)
    return rt


def test_session_modes_and_lists_match_jax():
    """One motion script through an incremental and a rebuild pair: the
    modes per tick are the reference's, the bits never differ."""
    rng = np.random.default_rng(7)
    n = 500
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (32, 2)).astype(np.float32)
    inc = _pair(pts, qpos, "incremental", churn_budget=0.25)
    reb = _pair(pts, qpos, "rebuild")
    script = [None, 20, None, 20, 400, 20]  # rows moved before each tick
    want_inc = ["skip", "incremental", "skip", "incremental", "rebuild",
                "incremental"]
    for t, mv in enumerate(script):
        if mv:
            ids = rng.choice(n, mv, replace=False)
            new = rng.uniform(0, SIDE, (mv, 2)).astype(np.float32)
            for s in inc + reb:
                s.update_objects(ids, new)
        ri, rr = _same_tick(*inc), _same_tick(*reb)
        assert ri.maintenance == want_inc[t], t
        assert rr.maintenance == ("rebuild" if mv else "skip"), t
        _equal(rr.nn_idx, ri.nn_idx)
        _index_equal(reb[1].index, inc[1].index)


def test_session_duplicate_ids_count_once_against_budget():
    """One object moved many times between submits is one moved row (the
    budget here is 10 rows: 30 batches over the same 6 objects stay in it),
    and its old position is the first touch's."""
    rng = np.random.default_rng(9)
    n = 200
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (8, 2)).astype(np.float32)
    js, ts = _pair(pts, qpos, "incremental", churn_budget=0.05)
    _same_tick(js, ts)
    for _ in range(30):
        ids = [0, 1, 2, 3, 4, 5, 3]  # a duplicate inside the batch too
        new = rng.uniform(0, SIDE, (7, 2)).astype(np.float32)
        js.update_objects(ids, new)
        ts.update_objects(ids, new)
    assert _same_tick(js, ts).maintenance == "incremental"
    _index_equal(jq.reindex_objects(js.index, js._positions), ts.index,
                 fields=FIELDS[:5])


def test_session_snapshot_ingest_forces_rebuild():
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, SIDE, (300, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (16, 2)).astype(np.float32)
    js, ts = _pair(pts, qpos, "incremental")
    assert _same_tick(js, ts).maintenance == "skip"  # the first build
    for s in (js, ts):
        s.update_objects([5], [[1.0, 2.0]])
    assert _same_tick(js, ts).maintenance == "incremental"
    snap = rng.uniform(0, SIDE, (300, 2)).astype(np.float32)
    for s in (js, ts):
        s.ingest_objects(snap)
        s.update_objects([7], [[3.0, 4.0]])  # a delta after it stays unknown
    assert _same_tick(js, ts).maintenance == "rebuild"


@pytest.mark.parametrize("m,want", [(16, "incremental"), (17, "rebuild")])
def test_session_churn_budget_boundary_matches_jax(m, want):
    """Exactly churn_budget x N pending rows splice; one more re-sorts."""
    rng = np.random.default_rng(15)
    n = 64
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (8, 2)).astype(np.float32)
    js, ts = _pair(pts, qpos, "incremental", churn_budget=0.25)
    _same_tick(js, ts)
    ids = rng.choice(n, m, replace=False)
    new = rng.uniform(0, SIDE, (m, 2)).astype(np.float32)
    for s in (js, ts):
        s.update_objects(ids, new)
    assert _same_tick(js, ts).maintenance == want


def test_session_drift_rebuild_reuses_spliced_order(monkeypatch):
    """A low rebuild_factor fires drift rebuilds; under the incremental spec
    each one, with moves pending, splices them (no build_index) and stays on
    the JAX session's bits."""
    calls = {"splice": 0, "build": 0}
    splice, build = tsession.reindex_objects_delta, tsession.build_index

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tsession, "reindex_objects_delta",
                        count("splice", splice))
    monkeypatch.setattr(tsession, "build_index", count("build", build))
    rng = np.random.default_rng(18)
    n = 400
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (16, 2)).astype(np.float32)
    js, ts = _pair(pts, qpos, "incremental", rebuild_factor=0.5,
                   churn_budget=0.25)
    rebuilds = 0
    for t in range(5):
        hj, ht = js.submit(), ts.submit()
        ids = rng.choice(n, 20, replace=False)
        new = rng.uniform(0, SIDE, (20, 2)).astype(np.float32)
        for s in (js, ts):  # staged while the tick is in flight
            s.update_objects(ids, new)
        rj, rt = hj.result(), ht.result()
        _equal(rj.nn_idx, rt.nn_idx)
        _equal(rj.nn_dist, rt.nn_dist)
        assert (rj.maintenance, rj.rebuilt) == (rt.maintenance, rt.rebuilt)
        assert ht.rebuilt_post == hj.rebuilt_post
        rebuilds += ht.rebuilt_post
        _index_equal(js.index, ts.index)
    assert rebuilds >= 1 and calls["build"] == 1  # only the first build
    assert calls["splice"] >= rebuilds


@pytest.mark.parametrize("ranks,want", [
    (list(range(17)), "rebuild"),             # 17 > 16 owned by shard 0
    (list(range(16)) + [64], "incremental"),  # the same total, spread
    (list(range(16)), "incremental"),         # shard 0 at its budget
])
def test_object_sharded_session_per_shard_budget(ranks, want):
    """object_sharded 4 (64 owned rows a shard, budget 16 each): movers
    concentrated in one shard defer the tick by the per-shard rule, though
    the global fraction stays in budget; the mode is the JAX rule's on the
    JAX index, and the lists equal the JAX single-plan session's."""
    rng = np.random.default_rng(17)
    n = 256
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (8, 2)).astype(np.float32)
    js, tsingle = _pair(pts, qpos, "incremental", churn_budget=0.25)
    ts = KnnSession(ServiceSpec(
        k=4, chunk=256, window=32, l_max=5, th_quad=32, side=SIDE,
        delta_pad=64, maintenance="incremental", churn_budget=0.25,
        backend="dense_topk", plan="object_sharded", mesh_shape=4,
        partitioner="equal", merge="dense_merge"), device="cpu")
    ts.ingest_objects(pts)
    ts.register_queries(qpos)
    _same_tick(js, tsingle)
    ts.submit().result()
    ids = np.asarray(js.index.ids)[ranks]
    over = jt.shard_churn_over_budget(
        js.index, jnp.asarray(np.sort(ids).astype(np.int32)), 4, 0.25)
    assert bool(over) == (want == "rebuild")
    new = rng.uniform(0, SIDE, (len(ids), 2)).astype(np.float32)
    for s in (js, tsingle, ts):
        s.update_objects(ids, new)
    rj = js.submit().result()
    rt = ts.submit().result()
    assert rt.maintenance == want
    assert rj.maintenance == "incremental"  # one shard: only the global rule
    _equal(rj.nn_idx, rt.nn_idx)
    _equal(rj.nn_dist, rt.nn_dist)
    _index_equal(jq.reindex_objects(js.index, js._positions), ts.index,
                 fields=FIELDS[:5])


@pytest.mark.parametrize("plan,mesh", [("single", None), ("sharded", 3),
                                       ("object_sharded", 4),
                                       ("hybrid", (2, 2))])
def test_incremental_session_on_every_plan(plan, mesh):
    """Skip, splice, skip on every plan (the mesh plans derive their local
    trees from the spliced order), the lists equal to the JAX single-plan
    session's."""
    rng = np.random.default_rng(16)
    n = 96
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    qpos = rng.uniform(0, SIDE, (16, 2)).astype(np.float32)
    kw = dict(k=4, window=16, chunk=32, l_max=5, th_quad=8, side=SIDE,
              churn_budget=0.25, delta_pad=16, maintenance="incremental",
              backend="dense_topk")
    js = JaxSession(JaxSpec(**kw))
    ts = KnnSession(ServiceSpec(plan=plan, mesh_shape=mesh, **kw),
                    device="cpu")
    for s in (js, ts):
        s.ingest_objects(pts)
        s.register_queries(qpos)
    ids = rng.choice(n, 8, replace=False)
    new = rng.uniform(0, SIDE, (8, 2)).astype(np.float32)
    for t, want in enumerate(("skip", "incremental", "skip")):
        if t == 1:
            for s in (js, ts):
                s.update_objects(ids, new)
        rj, rt = js.submit().result(), ts.submit().result()
        assert rj.maintenance == rt.maintenance == want, (plan, t)
        _equal(rj.nn_idx, rt.nn_idx)
        _equal(rj.nn_dist, rt.nn_dist)
        _index_equal(js.index, ts.index)
