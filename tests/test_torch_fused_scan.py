"""Parity: the fused SCAN-step merge and its helpers against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in Pallas interpret mode, as the reference's own tests run it.  Every
comparison is bitwise (``np.array_equal`` on the raw bits, tolerance 0).  The
CUDA kernel itself is held against the plain version by
``tests/test_torch_gpu.py`` (marked ``gpu``; it skips without a card) and by
``chip_smoke.py``.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels import fused_scan as jfs
from repro.kernels import ops as jops
from repro.kernels import refine as jref
from repro_torch.kernels import fused_scan as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import refine as tref
from repro_torch.runtime import fma

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import edge_lists, kernel_inputs, odd_rows  # noqa: E402

torch.set_num_threads(2)

Q, W = 64, 64


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.tensor(np.asarray(x))


def _window(k, seed=0, q=Q, w=W):
    """Inputs with the kernel phase's edge rows: coincident points, distance
    ties with distinct ids, all-invalid rows, n_valid < k, partly filled and
    full current lists (numpy, float32/int32/bool)."""
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
    valid[16:24] = False  # all invalid
    valid[24:32] = False
    valid[24:32, : max(1, k // 2)] = True  # n_valid < k
    best_d = np.full((q, k), np.inf, np.float32)
    best_i = np.full((q, k), -1, np.int32)
    # rows 32..: current lists from a first merge, some cut short
    d0, i0 = tfs.fused_scan_merge_ref(
        _t(qx), _t(qy), _t(cy), _t(cx), _t(cids + (1 << 16)), _t(valid),
        _t(best_d), _t(best_i), k=k)
    keep = rng.integers(0, k + 1, q)
    cut = np.arange(k)[None, :] >= keep[:, None]
    cut[:32] = True
    best_d = np.where(cut, np.inf, d0.numpy()).astype(np.float32)
    best_i = np.where(cut, -1, i0.numpy()).astype(np.int32)
    return qx, qy, cx, cy, cids, valid, best_d, best_i


@pytest.mark.parametrize("k", [1, 8, 32])
def test_fused_scan_merge_matches_jax(k):
    args = _window(k, seed=k)
    jd, ji = jfs.fused_scan_merge(*args, k=k, interpret=True)
    td, ti = tfs.fused_scan_merge(*(_t(a) for a in args), k=k)
    _bits_equal(jd, td.numpy())
    _bits_equal(ji, ti.numpy())
    assert (td.numpy()[16:24] == np.inf).all()  # all-invalid rows stay empty


@pytest.mark.parametrize("k", [1, 8, 32])
def test_lex_sort_merge_matches_jax(k):
    """dense_topk / brute body: two stable sorts == the two-key lax.sort."""
    qx, qy, cx, cy, cids, valid, bd, bi = _window(k, seed=10 + k)
    qpos, cpos = np.stack([qx, qy], 1), np.stack([cx, cy], 2)
    jd, ji = jax.jit(jops._lex_sort_merge, static_argnames="k")(
        qpos, cpos, cids, valid, bd, bi, k=k)
    td, ti = tops._lex_sort_merge(_t(qpos), _t(cpos), _t(cids), _t(valid),
                                  _t(bd), _t(bi), k)
    _bits_equal(jd, td.numpy())
    _bits_equal(ji, ti.numpy())
    # every backend of the registry gives the same bits
    for name in tops.scan_backend_names():
        bd2, bi2 = tops.get_scan_backend(name)(
            _t(qpos), _t(cpos), _t(cids), _t(valid), _t(bd), _t(bi), k)
        _bits_equal(td.numpy(), bd2.numpy())
        _bits_equal(ti.numpy(), bi2.numpy())


def test_refine_helpers_match_jax():
    """bucket_refine_step (4 rounds, incl. an all-inf row whose NaN width
    must not leak) and masked_argmin_rounds with exact (d, id) duplicates."""
    rng = np.random.default_rng(3)
    d = (rng.random((32, 96)) * 50).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = np.inf
    d[0] = np.inf
    d[1, :40] = 7.0  # massed ties at the k-th value
    ids = rng.integers(0, 1000, d.shape).astype(np.int32)
    ids[2, 5], d[2, 5] = ids[2, 4], d[2, 4]  # an exact (d, id) duplicate
    lo = d.min(1)
    hi0 = np.where(np.isinf(d), -np.inf, d).max(1)
    hi = (np.maximum(hi0, lo) * np.float32(1 + 1e-6) + np.float32(1e-30))
    hi = hi.astype(np.float32)
    kth = np.full(32, 20, np.int32)
    jstate, tstate = (lo, hi, kth), (_t(lo), _t(hi), _t(kth))
    step = jax.jit(jref.bucket_refine_step, static_argnums=4)
    for _ in range(4):
        jstate = step(d, *jstate, 32)
        tstate = tref.bucket_refine_step(_t(d), *tstate, 32)
        for a, b in zip(jstate, tstate):
            _bits_equal(a, b.numpy())
    jd, ji = jax.jit(jref.masked_argmin_rounds, static_argnums=2)(d, ids, 24)
    td, ti = tref.masked_argmin_rounds(_t(d), _t(ids), 24)
    _bits_equal(jd, td.numpy())
    _bits_equal(ji, ti.numpy())


def test_fused_merge_is_exact_on_bucket_edge_lists():
    """Full lists whose first-round bucket edge lands on an entry that the
    division bins one bucket lower, merged with an empty window.  The
    reference's Pallas kernel loses the k-th entry of every such row (its
    histogram rank counts the edge entry below the bucket, so the prune
    radius falls under the k-th distance); the port counts ranks against the
    edges and equals the reference's exact two-sort merge bit for bit."""
    k, q, w = 32, 16, 8
    best_d = edge_lists(q, k, seed=3)
    best_i = np.arange(q * k, dtype=np.int32).reshape(q, k)
    qpos = np.zeros((q, 2), np.float32)
    cpos = np.zeros((q, w, 2), np.float32)
    cids = np.zeros((q, w), np.int32)
    valid = np.zeros((q, w), bool)
    args = (qpos, cpos, cids, valid, best_d, best_i)
    ld, li = jax.jit(jops._lex_sort_merge, static_argnames="k")(*args, k=k)
    np.testing.assert_array_equal(np.asarray(ld), best_d)  # nothing to drop
    td, ti = tops.fused_scan_merge_op(*(_t(a) for a in args), k=k)
    _bits_equal(ld, td.numpy())
    _bits_equal(li, ti.numpy())
    jd, _ = jops.fused_scan_merge_op(*args, k=k, interpret=True)
    assert np.isinf(np.asarray(jd)[:, k - 1]).all()  # the reference's fault


def _nan_rows(case, k):
    """``_window``'s inputs with a NaN in rows 32..63: a valid window entry
    (``window``), the same with three valid entries and empty lists
    (``window_few``), a list entry (``list``), or a list of a NaN and one
    finite entry with an empty window (``list_few``)."""
    qx, qy, cx, cy, cids, valid, bd, bi = _window(k, seed=20 + k)
    rows = slice(32, 64)
    if case == "window":
        valid[rows, 3] = True
        cx[rows, 3] = np.nan
    elif case == "window_few":
        valid[rows] = False
        valid[rows, :3] = True
        cy[rows, 1] = np.nan
        bd[rows], bi[rows] = np.inf, -1
    elif case == "list":
        bd[rows, k // 2] = np.nan
    else:
        valid[rows] = False
        bd[rows], bi[rows] = np.inf, -1
        bd[rows, 0] = np.nan
        if k > 1:
            bd[rows, 1], bi[rows, 1] = 5.0, 77
    return qx, qy, cx, cy, cids, valid, bd, bi


@pytest.mark.parametrize("case", ["window", "window_few", "list", "list_few"])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_nan_rows_match_jax(case, k):
    """A NaN distance makes the row's lo, interval and radius NaN, as
    ``jnp.min`` propagates it: with n_valid >= k (entries not +inf, NaN
    included) the merge empties the row; with fewer, the radius is +inf and
    only the NaN entries drop.  The port's plain version gives the
    reference's bits, through the ops, on both precisions."""
    qx, qy, cx, cy, cids, valid, bd, bi = _nan_rows(case, k)
    qpos, cpos = np.stack([qx, qy], 1), np.stack([cx, cy], 2)
    args = (qpos, cpos, cids, valid, bd, bi)
    n_valid = (~np.isinf(bd)).sum(1) + (valid & ~np.isinf(cx)).sum(1)
    for precision in ("mixed", "fp32"):
        jd, ji = jops.fused_scan_merge_op(*args, k=k, precision=precision,
                                          interpret=True)
        td, ti = tops.fused_scan_merge_op(*(_t(a) for a in args), k=k,
                                          precision=precision)
        _bits_equal(jd, td.numpy())
        _bits_equal(ji, ti.numpy())
        assert not np.isnan(td.numpy()).any()
    # the fp32 run (the last): NaN rows with n_valid >= k come out empty
    full = np.zeros(Q, bool)
    full[32:64] = n_valid[32:64] >= k
    empty = np.isinf(td.numpy()).all(1) & (ti.numpy() == -1).all(1)
    if case in ("window", "list") or k == 1:
        assert full[32:64].all()
    assert empty[full].all()
    if case == "list_few" and k > 2:
        np.testing.assert_array_equal(ti.numpy()[32:64, :2],
                                      [[77, -1]] * 32)


_BANDS = {"coincident": 0, "ties": 1, "all_invalid": 2, "few_valid": 3,
          "bucket_edge": 4, "unsorted_max_last": 5, "unsorted": 6,
          "random": 11}


@pytest.mark.parametrize("band", list(_BANDS))
@pytest.mark.parametrize("k", [8, 32])
def test_fused_merge_is_the_k_selection_of_its_row(band, k):
    """The fact B1's queue path rests on: on rows of squared distances
    (entries +0 or above, +inf included, no NaN) the fused merge is the k
    smallest ``(d2, id)`` pairs of ``list ++ window d2``, whatever the
    order of the list; ``topk_select_ref`` (the two-key sort) computes that
    selection.  ``chip_smoke.kernel_inputs``' bands: zero distances, ties,
    all-invalid rows with empty lists, fewer than k valid, full lists on a
    bucket edge, lists out of order, random rows."""
    q, w = 256, 64
    args = kernel_inputs(q, w, k, "cpu", seed=k)
    qx, qy, cx, cy, cids, valid, bd, bi = args
    e = q // 16
    rows = slice(_BANDS[band] * e, q if band == "random" else
                 (_BANDS[band] + 1) * e)
    assert not odd_rows(q, "cpu")[rows].any()
    dx, dy = cx - qx[:, None], cy - qy[:, None]
    d2 = torch.where(valid, fma(dx, dx, dy * dy), float("inf"))
    row_d, row_i = torch.cat([bd, d2], 1), torch.cat([bi, cids], 1)
    assert (row_d[rows] >= 0).all()  # +0 or above, no NaN
    got = tfs.fused_scan_merge_ref(*args, k=k)
    want = tops.topk_select_ref(row_d, row_i, k)
    _bits_equal(got[0][rows].numpy(), want[0][rows].numpy())
    _bits_equal(got[1][rows].numpy(), want[1][rows].numpy())
    if band == "all_invalid":
        assert torch.isinf(got[0][rows]).all()


def test_op_pads_ragged_q():
    """fused_scan_merge_op pads Q to Q_TILE and slices back."""
    k = 8
    qx, qy, cx, cy, cids, valid, bd, bi = _window(k, seed=5)
    q = 13
    qpos, cpos = np.stack([qx, qy], 1)[:q], np.stack([cx, cy], 2)[:q]
    jd, ji = jops.fused_scan_merge_op(qpos, cpos, cids[:q], valid[:q],
                                      bd[:q], bi[:q], k=k, interpret=True)
    td, ti = tops.fused_scan_merge_op(_t(qpos), _t(cpos), _t(cids[:q]),
                                      _t(valid[:q]), _t(bd[:q]), _t(bi[:q]),
                                      k=k)
    assert td.shape == (q, k)
    _bits_equal(jd, td.numpy())
    _bits_equal(ji, ti.numpy())


def test_wrapper_rejects_bad_inputs():
    k = 8
    args = [_t(a) for a in _window(k)]
    before = tfs.fused_scan_merge.launches
    bad = list(args)
    bad[4] = bad[4].to(torch.int64)
    with pytest.raises(ValueError, match="cids"):
        tfs.fused_scan_merge(*bad, k=k)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fused_scan_merge(*bad, k=k)
    with pytest.raises(ValueError, match="Q_TILE"):
        tfs.fused_scan_merge(*(a[:12] for a in args), k=k)
    tfs.fused_scan_merge(*args, k=k)
    assert tfs.fused_scan_merge.launches == before  # the CPU never launches
