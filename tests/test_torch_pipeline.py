"""Parity: the port's k-NN sweep against the JAX reference, on one index.

The reference builds the index; ``repro_torch.convert`` carries its fields
across, so both sweeps run against the same bits.  Every comparison is
bitwise (``np.array_equal`` on the raw bits, tolerance 0): ids, distances,
``KnnStats`` and the per-query candidate counts ``cand_q``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from repro_torch.testing import given, settings, strategies as st

from repro.core import pipeline as jp
from repro.core import plan as jplan
from repro.core import quadtree as jq
from repro.core.executor import resolve_executor as j_executor
from repro.data.generators import make_workload
from repro_torch import convert
from repro_torch.core import pipeline as tp
from repro_torch.core import plan as tplan
from repro_torch.core import quadtree as tq
from repro_torch.core.executor import resolve_executor as t_executor

torch.set_num_threads(2)

SIDE = 1000.0
L_MAX, TH = 5, 16


def _bits_equal(a, b, what=""):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _stats_equal(js, ts):
    for f in ("iterations", "candidates", "leaves_visited"):
        _bits_equal(getattr(js, f), getattr(ts, f).numpy(), f)


def _indexes(family, n, seed=1):
    wl = make_workload(n, family, seed=seed, side=SIDE)
    pts = wl.positions()
    qpos, qid = wl.query_batch(1.0)
    jidx = jq.build_index(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=L_MAX,
                          th_quad=TH)
    fields = {f: np.asarray(getattr(jidx, f)) for f in convert.INDEX_FIELDS}
    tidx = convert.index_from_numpy(fields, l_max=L_MAX, th_quad=TH,
                                    device="cpu")
    return jidx, tidx, np.asarray(qpos), np.asarray(qid)


@pytest.mark.parametrize("family,n,k", [
    ("uniform", 1500, 8), ("gaussian", 1500, 8), ("network", 1500, 8),
    ("uniform", 5, 8),  # n < k: the lists pad with (-1, inf)
])
def test_knn_query_batch_matches_jax(family, n, k):
    jidx, tidx, qpos, qid = _indexes(family, n)
    window = 32
    ji, jd, jst = jp.knn_query_batch(jidx, qpos, qid, k=k, window=window,
                                     backend="dense_topk")
    ti, td, tst = tp.knn_query_batch(tidx, qpos, qid, k=k, window=window,
                                     backend="dense_topk")
    _bits_equal(ji, ti.numpy(), "ids")
    _bits_equal(jd, td.numpy(), "dist")
    _stats_equal(jst, tst)
    if n < k:
        assert (ti.numpy()[:, n - 1:] == -1).all()

    # the sorted sweep itself: per-query candidate counts
    order, _ = jp._sort_unsort(jidx, jnp.asarray(qpos))
    t_order, _ = tp._sort_unsort(tidx, torch.tensor(qpos))
    _bits_equal(np.asarray(order).astype(np.int64), t_order.numpy(), "order")
    max_nav = jp.default_max_nav(L_MAX)
    assert tp.default_max_nav(L_MAX) == max_nav
    *_, j_cq = jp._knn_sorted(jidx, jnp.asarray(qpos)[order],
                              jnp.asarray(qid)[order], k, window, max_nav,
                              100_000, j_executor("dense_topk"))
    *_, t_cq = tp._knn_sorted_impl(tidx, torch.tensor(qpos)[t_order],
                                   torch.tensor(qid)[t_order], k, window,
                                   max_nav, 100_000, t_executor("dense_topk"))
    _bits_equal(j_cq, t_cq.numpy(), "cand_q")


@pytest.mark.parametrize("backend,max_iters", [
    ("dense_topk", 100_000),
    ("dense_topk", 3),  # every chunk stops at its own trip cap
    ("fused_bucket", 100_000),
])
def test_single_plan_matches_jax(backend, max_iters):
    """Chunked single plan: per-chunk trip counts summed, cost EMA threaded
    through two ticks (the second with a non-zero history)."""
    jidx, tidx, qpos, qid = _indexes("gaussian", 700, seed=4)
    k, window, chunk = 8, 32, 256
    qp, qi = jplan.pad_queries(qpos, qid, chunk)
    tq_p, tq_i = tplan.pad_queries(qpos, qid, chunk)
    _bits_equal(qp, tq_p, "padded qpos")
    _bits_equal(qi, tq_i, "padded qid")
    kw = dict(k=k, window=window, chunk=chunk,
              max_nav=jp.default_max_nav(L_MAX), max_iters=max_iters)
    jcost = None
    tcost = torch.zeros(qp.shape[0])
    for _ in range(2):
        ji, jd, jaux = jplan.run_plan_device(
            jidx, jnp.asarray(qp), jnp.asarray(qi), jcost,
            executor=j_executor(backend), plan=jplan.SinglePlan(), **kw)
        ti, td, taux = tplan.resolve_plan("single").run(
            tidx, torch.tensor(qp), torch.tensor(qi), tcost,
            executor=t_executor(backend), **kw)
        _bits_equal(ji, ti.numpy(), "ids")
        _bits_equal(jd, td.numpy(), "dist")
        _stats_equal(jaux.stats, taux.stats)
        _bits_equal(jaux.qcost_next, taux.qcost_next.numpy(), "qcost_next")
        _bits_equal(jaux.shard_iterations, taux.shard_iterations.numpy())
        _bits_equal(jaux.shard_candidates, taux.shard_candidates.numpy())
        jcost, tcost = jaux.qcost_next, taux.qcost_next


def test_unported_plans_raise():
    """Every plan of the reference resolves now (ROADMAP A10, on one
    device), and each accepts ``maintenance="incremental"`` (A8); unknown
    names still raise."""
    from repro_torch.api import ServiceSpec

    for name, mesh in (("sharded", 3), ("object_sharded", 4),
                       ("hybrid", (2, 3))):
        plan = tplan.resolve_plan(name, num_devices=mesh,
                                  partitioner="cost_balanced",
                                  merge="fused_multi")
        assert plan.name == name
        assert ServiceSpec(plan=name, mesh_shape=mesh).plan == name
        spec = ServiceSpec(plan=name, mesh_shape=mesh,
                           maintenance="incremental")
        assert (spec.plan, spec.maintenance) == (name, "incremental")
    with pytest.raises(ValueError, match="unknown execution plan"):
        tplan.resolve_plan("nope")
    with pytest.raises(ValueError, match="unknown execution plan"):
        ServiceSpec(plan="nope")


@settings(max_examples=15, deadline=None)
@given(
    st.lists(st.tuples(st.floats(0, 999.9), st.floats(0, 999.9)),
             min_size=3, max_size=200),
    st.integers(1, 12),
    st.integers(2, 5),
    st.integers(2, 24),
)
def test_property_random_sets(points, k, l_max, th):
    """The reference's property (tests/test_pipeline.py), same name and
    strategies: any point set, any k and tree shape, every object a query;
    the port's sweep equals JAX's bitwise, ids, distances and stats, on
    indexes built by each package."""
    pts = np.asarray(points, np.float32)
    qid = np.arange(len(pts), dtype=np.int32)
    jidx = jq.build_index(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=l_max,
                          th_quad=th)
    tidx = tq.build_index(torch.tensor(pts), torch.zeros(2), SIDE,
                          l_max=l_max, th_quad=th)
    ji, jd, jst = jp.knn_query_batch(jidx, pts, qid, k=k, window=16,
                                     backend="dense_topk")
    ti, td, tst = tp.knn_query_batch(tidx, pts, qid, k=k, window=16,
                                     backend="dense_topk")
    _bits_equal(ji, ti.numpy(), "ids")
    _bits_equal(jd, td.numpy(), "dist")
    _stats_equal(jst, tst)
