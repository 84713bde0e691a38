"""Parity: ``precision="mixed"`` (the bf16 widened prefilter) against JAX.

The prefilter keeps a window entry when its bf16 distance is within the
current k-th distance widened by ``MIXED_WIDEN``; it must never drop an entry
with ``d2 <= kth``, so every merge under ``mixed`` gives fp32's lists bit for
bit.  The port rounds each bf16 operation once, as its CUDA kernel does; the
reference's CPU program may keep excess precision there, so the two masks
need not agree entry for entry, while the merged lists must.  On the CPU the
``fused_bucket`` wrapper runs its plain version; the JAX kernel runs in
Pallas interpret mode.  The mixed CUDA kernel is held against the plain
version by ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KnnSession as JaxSession
from repro.api import ServiceSpec as JaxSpec
from repro.data.generators import make_workload
from repro.kernels import fused_scan as jfs
from repro.kernels import ops as jops
from repro.kernels import refine as jref
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.core.executor import QueryExecutor
from repro_torch.kernels import MIXED_WIDEN, mixed_prune_keep
from repro_torch.kernels import fused_scan as tfs
from repro_torch.kernels import ops as tops
from repro_torch.runtime import fma

torch.set_num_threads(2)


def _bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("scale", [1.0, 1e3, 22_500.0])
@pytest.mark.parametrize("seed", [0, 7, 91])
def test_mixed_prune_keep_is_conservative(seed, scale):
    """The port of ``tests/test_kernels.py``'s test: the prefilter never
    drops a candidate at or inside the exact k-th distance (coincident
    points and a kth = inf row included), and it does prune far ones."""
    assert MIXED_WIDEN > (1 + 2.0 ** -8) ** 5  # margin over 5 roundings
    rng = np.random.default_rng(seed)
    t, w, k = 16, 256, 8
    qpos = rng.uniform(0, scale, (t, 2)).astype(np.float32)
    cpos = rng.uniform(0, scale, (t, w, 2)).astype(np.float32)
    cpos[:, :7] = qpos[:, None, :]  # coincident candidates (d2 = 0)
    dx = _t(cpos[:, :, 0] - qpos[:, None, 0])
    dy = _t(cpos[:, :, 1] - qpos[:, None, 1])
    d2 = fma(dx, dx, dy * dy).numpy()  # the merge's distance
    kth = np.sort(d2, axis=1)[:, k - 1].astype(np.float32)
    kth[0] = np.inf  # under-full row: everything must be kept
    keep = mixed_prune_keep(dx, dy, _t(kth)).numpy()
    inside = d2 <= kth[:, None]
    assert (keep | ~inside).all(), "prefilter dropped an in-boundary entry"
    assert keep[0].all()
    assert (~keep[1:] & (d2[1:] > 2.0 * kth[1:, None])).sum() > 0
    # the reference's mask is conservative on the same deltas too
    jkeep = np.asarray(jax.jit(jref.mixed_prune_keep)(
        jnp.asarray(dx.numpy()), jnp.asarray(dy.numpy()), jnp.asarray(kth)))
    assert (jkeep | ~inside).all()


def _window(k, seed, q=64, w=64):
    """Windows around the queries and current lists from a first merge of
    another such window (some cut short, some empty), so the prefilter has
    a finite k-th distance to prune against on most rows."""
    rng = np.random.default_rng(seed)
    qx = rng.uniform(0, 100, q).astype(np.float32)
    qy = rng.uniform(0, 100, q).astype(np.float32)
    cx = (qx[:, None] + rng.normal(0, 8, (q, w))).astype(np.float32)
    cy = (qy[:, None] + rng.normal(0, 8, (q, w))).astype(np.float32)
    cids = rng.permutation(1 << 16)[: q * w].reshape(q, w).astype(np.int32)
    valid = rng.random((q, w)) < 0.85
    cx[:8, ::5], cy[:8, ::5] = qx[:8, None], qy[:8, None]  # d2 == 0
    sign = np.where(rng.random((8, w)) < 0.5, -1, 1)
    cx[8:16] = qx[8:16, None] + sign * rng.integers(1, 3, (8, w))  # ties
    cy[8:16] = qy[8:16, None]
    inf_d = np.full((q, k), np.inf, np.float32)
    neg_i = np.full((q, k), -1, np.int32)
    d0, i0 = tfs.fused_scan_merge_ref(
        _t(qx), _t(qy), _t(cy), _t(cx), _t(cids + (1 << 16)), _t(valid),
        _t(inf_d), _t(neg_i), k=k)
    keep = rng.integers(0, k + 1, q)
    keep[16:] = np.where(rng.random(q - 16) < 0.7, k, keep[16:])
    cut = np.arange(k)[None, :] >= keep[:, None]
    best_d = np.where(cut, np.inf, d0.numpy()).astype(np.float32)
    best_i = np.where(cut, -1, i0.numpy()).astype(np.int32)
    return qx, qy, cx, cy, cids, valid, best_d, best_i


@pytest.mark.parametrize("k", [1, 8, 32])
def test_fused_scan_merge_mixed_matches_fp32_and_jax(k):
    args = _window(k, seed=20 + k)
    targs = [_t(a) for a in args]
    dx = targs[2] - targs[0][:, None]
    dy = targs[3] - targs[1][:, None]
    pruned = (targs[5] & ~mixed_prune_keep(dx, dy, targs[6][:, k - 1])).sum()
    assert pruned > 0  # the prefilter has work to do here
    before = (tfs.fused_scan_merge.launches,
              tfs.fused_scan_merge.mixed_launches)
    md, mi = tfs.fused_scan_merge(*targs, k=k, precision="mixed")
    assert (tfs.fused_scan_merge.launches,
            tfs.fused_scan_merge.mixed_launches) == before
    fd, fi = tfs.fused_scan_merge(*targs, k=k)
    _bits_equal(fd.numpy(), md.numpy(), "mixed vs fp32 distances")
    _bits_equal(fi.numpy(), mi.numpy(), "mixed vs fp32 ids")
    jd, ji = jfs.fused_scan_merge(*args, k=k, precision="mixed",
                                  interpret=True)
    _bits_equal(jd, md.numpy(), "JAX mixed distances")
    _bits_equal(ji, mi.numpy(), "JAX mixed ids")
    # the op pads a ragged Q and passes the precision through
    qpos, cpos = np.stack(args[:2], 1)[:13], np.stack(args[2:4], 2)[:13]
    od, oi = tops.fused_scan_merge_op(
        _t(qpos), _t(cpos), *(targs[i][:13] for i in (4, 5, 6, 7)), k=k,
        precision="mixed")
    _bits_equal(fd.numpy()[:13], od.numpy())
    _bits_equal(fi.numpy()[:13], oi.numpy())


@pytest.mark.parametrize("k", [1, 8, 32])
def test_lex_sort_merge_mixed_matches_fp32_and_jax(k):
    """dense_topk / brute under mixed: fp32's bits and the JAX backend's."""
    qx, qy, cx, cy, cids, valid, bd, bi = _window(k, seed=40 + k)
    qpos, cpos = np.stack([qx, qy], 1), np.stack([cx, cy], 2)
    jd, ji = jax.jit(jops._lex_sort_merge, static_argnames=(
        "k", "precision"))(qpos, cpos, cids, valid, bd, bi, k=k,
                           precision="mixed")
    targs = [_t(a) for a in (qpos, cpos, cids, valid, bd, bi)]
    md, mi = tops._lex_sort_merge(*targs, k, precision="mixed")
    fd, fi = tops._lex_sort_merge(*targs, k)
    _bits_equal(jd, md.numpy())
    _bits_equal(ji, mi.numpy())
    _bits_equal(fd.numpy(), md.numpy())
    _bits_equal(fi.numpy(), mi.numpy())


def _spec_kw(backend, precision):
    return dict(k=6, th_quad=24, l_max=6, window=32, chunk=64,
                side=22_500.0, delta_pad=64, backend=backend,
                precision=precision)


@pytest.mark.parametrize("backend", ["dense_topk", "fused_bucket"])
def test_mixed_session_bitwise_over_ticks(backend):
    """The port of ``tests/test_api.py::test_mixed_precision_session_bitwise_
    over_ticks``: a mixed session with delta ingest over three frames of a
    moving gaussian workload equals the port's fp32 session and the JAX
    mixed session, tick for tick: lists, iterations, candidates, rebuilds."""
    w = make_workload(500, "gaussian", seed=2, hotspots=4)
    qid = np.arange(500, dtype=np.int32)
    frames = []
    for _ in range(3):
        frames.append(w.positions().copy())
        w.advance()

    def drive(sess):
        sess.ingest_objects(frames[0])
        hq = sess.register_queries(frames[0], qid)
        out = []
        for t, p in enumerate(frames):
            if t > 0:
                moved = np.nonzero((p != frames[t - 1]).any(1))[0].astype(
                    np.int32)
                sess.update_objects(moved, p[moved])
                sess.update_queries(hq, p)
            out.append(sess.submit().result())
        return out

    mixed = drive(KnnSession(ServiceSpec(**_spec_kw(backend, "mixed")),
                             device="cpu"))
    fp32 = drive(KnnSession(ServiceSpec(**_spec_kw(backend, "fp32")),
                            device="cpu"))
    ref = drive(JaxSession(JaxSpec(**_spec_kw(backend, "mixed"))))
    for t, (rm, rf, rj) in enumerate(zip(mixed, fp32, ref)):
        for other, what in ((rf, "fp32"), (rj, "JAX mixed")):
            _bits_equal(other.nn_idx, rm.nn_idx, f"tick {t} ids vs {what}")
            _bits_equal(other.nn_dist, rm.nn_dist,
                        f"tick {t} distances vs {what}")
            assert (rm.iterations, rm.candidates, rm.rebuilt) == (
                other.iterations, other.candidates, other.rebuilt), what


def test_mixed_is_accepted_and_unknown_precisions_raise():
    assert ServiceSpec(precision="mixed").precision == "mixed"
    assert QueryExecutor(backend="fused_bucket",
                         precision="mixed").precision == "mixed"
    with pytest.raises(ValueError, match="precision"):
        ServiceSpec(precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        QueryExecutor(precision="bf16")
    args = [_t(a) for a in _window(4, seed=1, q=16, w=8)]
    with pytest.raises(ValueError, match="precision"):
        tfs.fused_scan_merge(*args, k=4, precision="bf16")
