"""Parity: the port's result sink (``collect="stats"`` and ``"none"``)
against the JAX package's.

The same seeded numpy inputs go through the reference's ``_stats_update`` and
the port's, and the same ticks through a JAX and a torch session.  Bitwise
(tolerance 0, on the raw bits): ``kth_dist``, both maxima, ``shard_hits``,
``n_live`` and the sink's new state, and every list and counter of the
sessions.  The two means, ``kth_drift_mean`` and ``churn_mean``, are f32
sums whose order differs between XLA and PyTorch: bitwise where every
addend and partial sum is exact (dyadic values, ``n_valid`` a power of
two), and within ``rtol=2**-20`` elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KnnSession as JaxSession
from repro.api import ServiceSpec as JaxSpec
from repro.api.sink import SinkState as JaxState
from repro.api.sink import _stats_update as jax_stats_update
from repro.api.sink import init_sink_state as jax_init_state
from repro.core.quadtree import build_index as jax_build_index
from repro.data.generators import make_workload
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.api.sink import SinkState, _stats_update, init_sink_state
from repro_torch.core.quadtree import build_index

torch.set_num_threads(2)

SIDE = 1000.0
N = 300
QP, K = 64, 8
MEAN_RTOL = 2.0 ** -20
FIELDS = ("kth_dist", "kth_drift_max", "churn_max", "shard_hits", "n_live")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _indexes(seed=0):
    pts = make_workload(N, "uniform", seed=seed, side=SIDE).positions()
    jidx = jax_build_index(jnp.asarray(pts), jnp.asarray([0.0, 0.0],
                                                         jnp.float32),
                           SIDE, l_max=5, th_quad=16)
    tidx = build_index(torch.tensor(pts), (0.0, 0.0), SIDE, l_max=5,
                       th_quad=16)
    _same(np.asarray(jidx.ids), tidx.ids.numpy())
    return jidx, tidx


def _lists(rng, dyadic, prev_idx=None):
    """(QP, K) ascending lists with -1 / inf padding tails: full rows, rows
    with fewer than k entries, empty rows; ids overlap ``prev_idx`` in part.
    """
    counts = (rng.choice([0, 1, 2, 4, 8], QP) if dyadic
              else rng.integers(0, K + 1, QP))
    counts[:QP // 2] = K  # most rows full
    idx = np.full((QP, K), -1, np.int32)
    dist = np.full((QP, K), np.inf, np.float32)
    for r in range(QP):
        c = counts[r]
        ids = rng.choice(N, c, replace=False).astype(np.int32)
        if prev_idx is not None and c:
            old = prev_idx[r][prev_idx[r] >= 0]
            keep = rng.integers(0, min(c, old.size) + 1)
            if keep:
                # some of last tick's ids again, the rest new ones
                fresh = np.setdiff1d(ids, old[:keep])[: c - keep]
                ids = np.concatenate([old[:keep], fresh])
                if ids.size < c:
                    extra = np.setdiff1d(np.arange(N, dtype=np.int32), ids)
                    ids = np.concatenate([ids, extra[: c - ids.size]])
                ids = rng.permutation(ids).astype(np.int32)
        idx[r, :c] = ids
        if dyadic:
            d = rng.integers(0, 64, c) / 8.0
        else:
            d = rng.uniform(0, 50, c)
        dist[r, :c] = np.sort(d).astype(np.float32)
    return idx, dist


def _run(jstate, tstate, idx, dist, jidx, tidx, bounds, n_live, shards):
    use = bounds is not None
    jb = jnp.asarray(bounds if use else np.zeros((1,), np.int32), jnp.int32)
    jnew, jagg = jax_stats_update(
        jstate, jnp.asarray(idx), jnp.asarray(dist), jidx, jb,
        jnp.int32(n_live), num_shards=shards, use_bounds=use)
    tb = torch.tensor(bounds, dtype=torch.int32) if use else None
    tnew, tagg = _stats_update(
        tstate, torch.tensor(idx), torch.tensor(dist), tidx, tb, n_live,
        num_shards=shards, use_bounds=use)
    return jnew, jagg, tnew, tagg


def _check(jnew, jagg, tnew, tagg, exact_means):
    for f in FIELDS:
        _same(np.asarray(getattr(jagg, f)), getattr(tagg, f).numpy())
    for f in ("prev_idx", "prev_kth"):
        _same(np.asarray(getattr(jnew, f)), getattr(tnew, f).numpy())
    for f in ("kth_drift_mean", "churn_mean"):
        want = np.asarray(getattr(jagg, f))
        got = getattr(tagg, f).numpy()
        if exact_means:
            _same(want, got)
        else:
            np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=0)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n_live", [QP, 50])
@pytest.mark.parametrize("bounds,shards", [
    (None, 3), (np.array([0, 37, 37, 120, N], np.int32), 4)])
def test_stats_update_matches_jax(dyadic, n_live, bounds, shards):
    """Three ticks from the -1 sentinel state: the first sees no previous
    observation, the second part of the first's ids, the third a state whose
    rows were partly reset to the sentinel and partly carry inf k-th."""
    rng = np.random.default_rng(11 + dyadic + n_live)
    jidx, tidx = _indexes()
    jstate = jax_init_state(QP, K)
    tstate = init_sink_state(QP, K, "cpu")
    prev = None
    for t in range(3):
        idx, dist = _lists(rng, dyadic, prev)
        if t == 2:
            # a partial row-set reset, and rows whose k-th was inf
            pi = np.asarray(jstate.prev_idx).copy()
            pk = np.asarray(jstate.prev_kth).copy()
            pi[:5], pk[:5] = -1, -1.0
            pk[5:8] = np.inf
            jstate = JaxState(jnp.asarray(pi), jnp.asarray(pk))
            tstate = SinkState(torch.tensor(pi), torch.tensor(pk))
        jstate, jagg, tstate, tagg = _run(jstate, tstate, idx, dist, jidx,
                                          tidx, bounds, n_live, shards)
        _check(jstate, jagg, tstate, tagg, exact_means=dyadic)
        prev = idx
    assert float(np.asarray(jagg.churn_max)) > 0.0


def test_kept_count_blocks_match_one_block(monkeypatch):
    """The row-blocked id match equals the whole-tensor one."""
    from repro_torch.api import sink

    rng = np.random.default_rng(3)
    jidx, tidx = _indexes()
    idx, dist = _lists(rng, False)
    idx2, dist2 = _lists(rng, False, idx)
    state = init_sink_state(QP, K, "cpu")
    state, _ = _stats_update(state, torch.tensor(idx), torch.tensor(dist),
                             tidx, None, QP, num_shards=1, use_bounds=False)
    _, whole = _stats_update(state, torch.tensor(idx2), torch.tensor(dist2),
                             tidx, None, QP, num_shards=1, use_bounds=False)
    monkeypatch.setattr(sink, "_MATCH_CELLS", 7 * K * K)  # blocks of 7 rows
    _, blocked = _stats_update(state, torch.tensor(idx2),
                               torch.tensor(dist2), tidx, None, QP,
                               num_shards=1, use_bounds=False)
    for a, b in zip(whole, blocked):
        _same(a.numpy(), b.numpy())


def _pair(collect, **over):
    kw = dict(k=8, window=32, chunk=256, l_max=5, th_quad=16, side=SIDE,
              backend="dense_topk", rebuild_factor=1.2, delta_pad=64,
              collect=collect)
    kw.update(over)
    return JaxSession(JaxSpec(**kw)), KnnSession(ServiceSpec(**kw),
                                                 device="cpu")


def _same_agg(ja, ta):
    for f in FIELDS:
        _same(np.asarray(getattr(ja, f)), np.asarray(getattr(ta, f)))
    for f in ("kth_drift_mean", "churn_mean"):
        np.testing.assert_allclose(np.asarray(getattr(ta, f)),
                                   np.asarray(getattr(ja, f)),
                                   rtol=MEAN_RTOL, atol=0)


@pytest.mark.parametrize("collect", ["stats", "none"])
def test_session_collect_modes_match_jax(collect):
    """Four ticks: the snapshot build, a delta, a query drop (the row-set
    reset: churn 1 and drift 0 everywhere), then a fresh snapshot with the
    queries moved.  ``result_for`` before ``result()`` gives device rows
    equal to the reference's; after it, both raise."""
    n = 600
    js, ts = _pair(collect)
    pos = make_workload(n, "uniform", seed=4, side=SIDE).positions().copy()
    rng = np.random.default_rng(8)
    for s in (js, ts):
        s.ingest_objects(pos)
    own = np.arange(n // 2, dtype=np.int32)
    hj, ht = (s.register_queries(pos[: n // 2], own) for s in (js, ts))
    ext = rng.uniform(0, SIDE, (30, 2)).astype(np.float32)
    hj2, ht2 = (s.register_queries(ext) for s in (js, ts))
    for t in range(4):
        if t == 1:
            ids = rng.choice(n, n // 10, replace=False).astype(np.int32)
            new = (pos[ids] + rng.uniform(-20, 20, (ids.size, 2))).clip(
                0, SIDE - 1).astype(np.float32)
            pos[ids] = new
            for s in (js, ts):
                s.update_objects(ids, new)
        elif t == 2:
            js.drop_queries(hj2)
            ts.drop_queries(ht2)
        elif t == 3:
            pos = make_workload(n, "uniform", seed=5,
                                side=SIDE).positions().copy()
            for s, h in ((js, hj), (ts, ht)):
                s.ingest_objects(pos)
                s.update_queries(h, pos[: n // 2])
        jh, th = js.submit(), ts.submit()
        assert th.done() and th.compile_s == 0.0
        dev = th.result(materialize=False)
        assert th.result(materialize=False) is dev  # cached
        assert torch.is_tensor(dev.nn_idx)
        ji, jd, jq = jh.result_for(hj)
        ti, td, tq = th.result_for(ht)
        assert torch.is_tensor(ti)
        _same(np.asarray(ji), ti.numpy())
        _same(np.asarray(jd), td.numpy())
        _same(jq, tq)
        rj, rt = jh.result(), th.result()
        assert rt.nn_idx is None and rt.nn_dist is None
        assert (rj.iterations, rj.candidates, rj.rebuilt, rj.maintenance) == (
            rt.iterations, rt.candidates, rt.rebuilt, rt.maintenance)
        assert jh.rebuilt_post == th.rebuilt_post
        _same(rj.qids, rt.qids)
        if collect == "none":
            assert rt.aggregates is None and rt.collect_s == 0.0
            assert rt.shard_candidates is None and rt.kth_dist is None
        else:
            _same(rj.shard_candidates, rt.shard_candidates)
            _same(rj.shard_iterations, rt.shard_iterations)
            _same_agg(rj.aggregates, rt.aggregates)
            _same(np.asarray(rj.kth_dist), rt.kth_dist)
            assert rt.kth_dist.shape == (ts.query_count,)
            if t == 2:  # the row set changed: no previous observation
                assert float(rt.aggregates.churn_max) == 1.0
                assert float(rt.aggregates.kth_drift_max) == 0.0
        for h, hq in ((jh, hj), (th, ht)):
            with pytest.raises(RuntimeError, match="never"):
                h.result_for(hq)


def _reckon_hits(res, index, bounds, nq):
    """Reported ids of the live rows counted by owning shard: the Morton
    rank of each id, in the interval of ``bounds`` that holds it."""
    ids = index.ids.numpy()
    rank = np.empty(ids.size, np.int64)
    rank[ids] = np.arange(ids.size)
    got = res.nn_idx[:nq]
    flat = got[got >= 0]
    owner = np.searchsorted(bounds, rank[flat], side="right") - 1
    return np.bincount(owner, minlength=bounds.size - 1).astype(np.float32)


@pytest.mark.parametrize("plan,mesh,part", [
    ("object_sharded", 4, "equal"), ("hybrid", (2, 3), "cost_balanced")])
def test_shard_hits_follow_the_ownership_rule(plan, mesh, part):
    """On an object-axis plan the stats session's shard hits equal a numpy
    count over a full twin's lists, by the tick's own object boundaries."""
    n = 800
    kw = dict(k=8, window=32, chunk=256, l_max=5, th_quad=16, side=SIDE,
              backend="dense_topk", plan=plan, mesh_shape=mesh,
              partitioner=part)
    stats = KnnSession(ServiceSpec(collect="stats", **kw), device="cpu")
    full = KnnSession(ServiceSpec(**kw), device="cpu")
    pos = make_workload(n, "gaussian", seed=6, side=SIDE,
                        hotspots=3).positions().copy()
    rng = np.random.default_rng(2)
    for s in (stats, full):
        s.ingest_objects(pos)
        s.register_queries(pos[: n // 2], np.arange(n // 2, dtype=np.int32))
    for t in range(2):
        if t:
            ids = rng.choice(n, n // 20, replace=False).astype(np.int32)
            new = rng.uniform(0, SIDE, (ids.size, 2)).astype(np.float32)
            for s in (stats, full):
                s.update_objects(ids, new)
        rs = stats.submit().result()
        hf = full.submit()
        bounds = full._obj_bounds.numpy()
        rf = hf.result()
        want = _reckon_hits(rf, full.index, bounds, n // 2)
        assert want.size == stats.plan.object_axis_size
        _same(rs.aggregates.shard_hits, want)
        _same(rs.kth_dist, rf.nn_dist[:, -1])
        assert want.sum() == (rf.nn_idx >= 0).sum()
