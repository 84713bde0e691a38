"""Parity: the port's ``KnnSession`` against the JAX session, tick for tick.

Both sessions get the same object snapshots, delta batches (with duplicate
ids), query moves and drops, so their drift-rebuild decisions must agree as
well as their lists.  Every comparison is bitwise (``np.array_equal`` on the
raw bits, tolerance 0): ids, distances, iterations, candidates, ``rebuilt``,
``rebuilt_post`` and the maintenance mode of each tick.
"""
import numpy as np
import pytest
import torch

from repro.api import KnnSession as JaxSession
from repro.api import ServiceSpec as JaxSpec
from repro.data.generators import make_workload
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.runtime import resolve_device

torch.set_num_threads(2)

SIDE = 1000.0
CENTER = np.array([500.0, 500.0], np.float32)


def _same_tick(jh, th):
    rj, rt = jh.result(), th.result()
    np.testing.assert_array_equal(rj.nn_idx, rt.nn_idx)
    np.testing.assert_array_equal(rj.nn_dist.view(np.uint32),
                                  rt.nn_dist.view(np.uint32))
    np.testing.assert_array_equal(rj.qids, rt.qids)
    assert (rj.iterations, rj.candidates, rj.rebuilt, rj.maintenance) == (
        rt.iterations, rt.candidates, rt.rebuilt, rt.maintenance)
    assert jh.rebuilt_post == th.rebuilt_post
    assert th.finalized
    return rt


def _pair(n, backend, **over):
    kw = dict(k=8, window=32, chunk=256, l_max=5, th_quad=16, side=SIDE,
              backend=backend, rebuild_factor=1.2, delta_pad=64)
    kw.update(over)
    return JaxSession(JaxSpec(**kw)), KnnSession(ServiceSpec(**kw),
                                                 device="cpu")


def test_session_matches_jax_over_ticks():
    """Six ticks on dense_topk: small deltas, one delta that pulls a fifth of
    the objects to the centre (forces a drift rebuild), query moves, a drop,
    and two ticks submitted before either result is read."""
    n = 1500
    js, ts = _pair(n, "dense_topk")
    pos = make_workload(n, "uniform", seed=3, side=SIDE).positions().copy()
    rng = np.random.default_rng(7)
    for s in (js, ts):
        s.ingest_objects(pos)
    half = np.arange(n // 2, dtype=np.int32)
    hj = js.register_queries(pos[: n // 2], half)
    ht = ts.register_queries(pos[: n // 2], half)
    ext = rng.uniform(0, SIDE, (40, 2)).astype(np.float32)
    hj2, ht2 = js.register_queries(ext), ts.register_queries(ext)
    assert ts.query_count == js.query_count

    rebuilt_post = []
    t = 0
    while t < 6:
        if t == 4:  # pipelined: tick 5 is queued before tick 4 is read
            jh4, th4 = js.submit(), ts.submit()
            jh5, th5 = js.submit(), ts.submit()
            for jh, th in ((jh4, th4), (jh5, th5)):
                _same_tick(jh, th)
                rebuilt_post.append(th.rebuilt_post)
            break
        jh, th = js.submit(), ts.submit()
        _same_tick(jh, th)
        rebuilt_post.append(th.rebuilt_post)
        if t == 1:  # drift: a fifth of the objects collapse toward the centre
            ids = rng.choice(n, n // 5, replace=False).astype(np.int32)
            new = (CENTER + 0.05 * (pos[ids] - CENTER)).astype(np.float32)
        else:
            ids = rng.choice(n, n // 20, replace=False).astype(np.int32)
            new = (pos[ids] + rng.uniform(-20, 20, (ids.size, 2))).clip(
                0, SIDE - 1).astype(np.float32)
        # duplicate ids in one batch: the last observation wins
        ids = np.concatenate([ids, ids[:5]])
        new = np.concatenate([new, new[:5] + 1])
        for s in (js, ts):
            s.update_objects(ids, new)
        pos[ids] = new
        if t in (1, 2):
            q = (CENTER + rng.uniform(-30, 30, (40, 2))).astype(np.float32)
            js.update_queries(hj2, q)
            ts.update_queries(ht2, q)
        if t == 3:
            js.drop_queries(hj2)
            ts.drop_queries(ht2)
            assert ts.query_count == n // 2
        t += 1
    assert any(rebuilt_post), "the drift rule never fired"
    # a group's rows come back by handle
    ij, _, qj = jh5.result_for(hj)
    it, _, qt = th5.result_for(ht)
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_array_equal(qj, qt)


def test_session_matches_jax_fused_bucket():
    """The fused_bucket backend (the kernel's plain version on the CPU, the
    Pallas kernel in interpret mode) over a build tick and a delta tick."""
    n = 400
    js, ts = _pair(n, "fused_bucket")
    pos = make_workload(n, "gaussian", seed=5, side=SIDE).positions().copy()
    rng = np.random.default_rng(9)
    for s in (js, ts):
        s.ingest_objects(pos)
        s.register_queries(pos, np.arange(n, dtype=np.int32))
    for t in range(2):
        th = ts.submit()
        assert th.block_until_ready() is th
        rt = _same_tick(js.submit(), th)
        assert th.result() is rt  # idempotent
        ids = rng.choice(n, n // 10, replace=False).astype(np.int32)
        new = (pos[ids] + rng.uniform(-15, 15, (ids.size, 2))).clip(
            0, SIDE - 1).astype(np.float32)
        for s in (js, ts):
            s.update_objects(ids, new)


@pytest.mark.parametrize("field,value,item", [
    ("collect", "none", "A9"),
    ("collect", "stats", "A9"),
])
def test_spec_rejects_unported_values(field, value, item):
    """No value the reference's spec takes is unported any more: the collect
    modes that raised ``NotImplementedError`` naming their ROADMAP item
    build as the reference's do, and a value neither takes still raises."""
    import inspect

    from repro_torch.api import spec as spec_module

    assert getattr(ServiceSpec(**{field: value}), field) == getattr(
        JaxSpec(**{field: value}), field)
    assert item not in inspect.getsource(spec_module)
    with pytest.raises(ValueError, match=f"unknown {field}"):
        ServiceSpec(**{field: "bogus"})


def test_spec_defaults_and_validation_match_jax():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(ServiceSpec)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxSpec)}
    assert ours == ref
    with pytest.raises(ValueError, match="unknown backend"):
        ServiceSpec(backend="nope")
    with pytest.raises(ValueError, match="multiple of window"):
        ServiceSpec(window=100, chunk=8192)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """With no card, the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KnnSession(ServiceSpec())
    assert resolve_device("cpu") == torch.device("cpu")


def test_process_tick_and_set_queries_match_jax():
    """The snapshot convenience (ingest + ``set_queries`` + submit + result)
    over two ticks equals the reference's; ``set_queries`` invalidates the
    handles registered before it, in both packages."""
    n = 500
    js, ts = _pair(n, "dense_topk")
    g = np.random.default_rng(12)
    hj = js.register_queries(g.uniform(0, SIDE, (5, 2)))
    ht = ts.register_queries(g.uniform(0, SIDE, (5, 2)))
    for t in range(2):
        pos = make_workload(n, "uniform", seed=20 + t,
                            side=SIDE).positions()
        qid = np.arange(0, n, 3, dtype=np.int32)
        rj = js.process_tick(pos, pos[qid], qid)
        rt = ts.process_tick(pos, pos[qid], qid)
        np.testing.assert_array_equal(rj.nn_idx, rt.nn_idx)
        np.testing.assert_array_equal(rj.nn_dist.view(np.uint32),
                                      rt.nn_dist.view(np.uint32))
        np.testing.assert_array_equal(rj.qids, rt.qids)
        assert (rj.iterations, rj.rebuilt) == (rt.iterations, rt.rebuilt)
        assert rt.wall_s >= 0.0 and rt.compile_s == 0.0
        assert ts.query_count == js.query_count == qid.size
    for s, h in ((js, hj), (ts, ht)):
        with pytest.raises(KeyError, match="set_queries"):
            s.update_queries(h, np.zeros((5, 2), np.float32))
