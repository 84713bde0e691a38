"""The premises of B1's and B3's wide merge routes, on the CPU.

The wide merge of B1 (``csrc/fused_scan.cu``, k > 256) and of B3
(``csrc/merge_topk.cu``, ``merge_topk_lists`` past a row of 512) rest on
facts about the plain versions, which hold here without a card:

- On a row with no NaN and no set sign bit whose list ascends under the
  ``(d2, id)`` key (+inf entries all equal), the plain B1 equals the list
  merged with the window entries whose key is below the list's k-th,
  sorted (route 2's mirror), and equals a full sort of ``list ++ window``
  cut to k, which is also what B1's wide queue keeps.
- On two ascending lists with no NaN, the plain B3 equals their co-rank
  merge (route 3's mirror), negative and -inf entries included, and with a
  lone NaN in the first list's first column emitted first.
- The votes are needed: a NaN and a list out of order make either mirror
  differ from the plain version; a -0 changes the sign of an output zero
  only, which B1's vote sends to the wide template and B3's merge leaves
  as +0, as every key path does (``csrc/select_keys.cuh``).

The mirrors live here, not in the package: they follow the kernels' steps
one row at a time in Python.  Inputs are made from seeds with numpy.
"""
import heapq
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_scan import fused_scan_merge_ref
from repro_torch.kernels.merge_topk import merge_topk_lists_ref
from repro_torch.kernels.refine import mixed_prune_keep
from repro_torch.runtime import fma

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import edge_lists, same_values  # noqa: E402

INF = float("inf")


def _key(d: float, i: int):
    """select_keys.cuh's order as a tuple, as the kernels stage a list
    entry (run_key): +inf entries all equal, -0 as +0."""
    if d == INF:
        return (INF, -1)
    return (d + 0.0, i)


def _pair(key):
    """The output pair of a key (key_pair): (inf, -1) for +inf, -1 for
    -inf, a zero as +0."""
    d, i = key
    return (d, -1) if math.isinf(d) else (d, i)


def _window_d2(args, k, precision):
    """The window's d2 as the plain version computes it (+inf where
    invalid or, under ``mixed``, where the prefilter drops it)."""
    qx, qy, cx, cy, cids, valid, best_d, best_i = args
    dx = cx - qx[:, None]
    dy = cy - qy[:, None]
    if precision == "mixed":
        valid = valid & mixed_prune_keep(dx, dy, best_d[:, k - 1])
    return torch.where(valid, fma(dx, dx, dy * dy), torch.tensor(INF))


def _rows_out(rows, k):
    d = torch.tensor([[p[0] for p in r] for r in rows], dtype=torch.float32)
    i = torch.tensor([[p[1] for p in r] for r in rows], dtype=torch.int32)
    return d.reshape(len(rows), k), i.reshape(len(rows), k)


def route2_mirror(args, k, precision="fp32"):
    """B1's wide merge one row at a time: the window entries below the
    list's k-th key, sorted, merged with the list (the list's entry first
    on equal keys, as merged_at takes them)."""
    win = _window_d2(args, k, precision)
    rows = []
    for r in range(win.shape[0]):
        lk = [_key(float(d), int(i)) for d, i in zip(args[6][r], args[7][r])]
        kth = lk[k - 1]
        surv = sorted(key for key in (_key(float(d), int(i)) for d, i in
                                      zip(win[r], args[4][r])) if key < kth)
        merged = list(heapq.merge(lk, surv))[:k]
        rows.append([_pair(key) for key in merged])
    return _rows_out(rows, k)


def full_sort(args, k, precision="fp32"):
    """The k smallest (d2, id) pairs of ``list ++ window``, by a sort of
    the whole row: the exact k-selection that B1's wide queue keeps."""
    win = _window_d2(args, k, precision)
    rows = []
    for r in range(win.shape[0]):
        keys = [_key(float(d), int(i)) for d, i in zip(args[6][r], args[7][r])]
        keys += [_key(float(d), int(i)) for d, i in zip(win[r], args[4][r])]
        rows.append([_pair(key) for key in sorted(keys)[:k]])
    return _rows_out(rows, k)


def merged_at(a, b, j):
    """select_keys.cuh's merged_at: element j of the merge of ascending a
    and b, a's entry first on equal keys, by a co-rank binary search."""
    lo, hi = max(0, j - len(b)), min(j, len(a))
    while lo < hi:
        mid = (lo + hi) >> 1
        if b[j - mid - 1] < a[mid]:
            hi = mid
        else:
            lo = mid + 1
    if lo >= len(a):
        return b[j - lo]
    if j - lo >= len(b):
        return a[lo]
    return min(a[lo], b[j - lo])


def route3_mirror(da, ia, db, ib, k):
    """B3's wide merge one row at a time: the co-rank merge of the first
    min(c, k) keys of each list; a NaN in a[0] leaves first as
    (NaN, INT_MAX) and the rest merge after it."""
    rows = []
    for r in range(da.shape[0]):
        a = [_key(float(d), int(i)) for d, i in zip(da[r, :k], ia[r, :k])]
        b = [_key(float(d), int(i)) for d, i in zip(db[r, :k], ib[r, :k])]
        out = []
        if a and math.isnan(a[0][0]):
            out.append((float("nan"), 2 ** 31 - 1))
            a = a[1:]
        skip = len(out)
        for j in range(skip, k):
            t = j - skip
            out.append(_pair(merged_at(a, b, t)) if t < len(a) + len(b)
                       else (INF, -1))
        rows.append(out)
    return _rows_out(rows, k)


def _bits_equal(x, y):
    """Output lists equal bit for bit (a NaN's payload aside)."""
    (xd, xi), (yd, yi) = x, y
    nan = torch.isnan(xd) & torch.isnan(yd)
    return bool(((xd.view(torch.int32) == yd.view(torch.int32)) | nan).all()
                and torch.equal(xi, yi))


def b1_inputs(q, w, k, seed):
    """(Q,) queries, (Q, W) windows and (Q, k) ascending lists, made with
    numpy from ``seed``, in bands of q // 8 rows: coincident points, equal
    distances with distinct ids, rows with fewer than k valid entries,
    bucket-edge lists (``chip_smoke.edge_lists``) with an empty window,
    then lists partly filled and full (a first merge of another window)."""
    g = np.random.default_rng(seed)
    qx = g.uniform(0, 22_500, q).astype(np.float32)
    qy = g.uniform(0, 22_500, q).astype(np.float32)
    cx = (qx[:, None] + g.normal(0, 300, (q, w))).astype(np.float32)
    cy = (qy[:, None] + g.normal(0, 300, (q, w))).astype(np.float32)
    cids = g.integers(0, 1 << 30, (q, w), dtype=np.int32)
    valid = g.random((q, w)) < 0.9
    e = q // 8
    cx[:e, ::7], cy[:e, ::7] = qx[:e, None], qy[:e, None]
    off = g.integers(1, 4, (e, w)).astype(np.float32)
    cx[e:2 * e] = qx[e:2 * e, None] + np.where(g.random((e, w)) < 0.5, -off,
                                               off)
    cy[e:2 * e] = qy[e:2 * e, None]
    valid[2 * e:3 * e] = False
    valid[2 * e:3 * e, :5] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    px = t((qx[:, None] + g.normal(0, 300, (q, w))).astype(np.float32))
    py = t((qy[:, None] + g.normal(0, 300, (q, w))).astype(np.float32))
    full_d, full_i = fused_scan_merge_ref(
        t(qx), t(qy), px, py, t(g.integers(0, 1 << 30, (q, w),
                                           dtype=np.int32)),
        t(g.random((q, w)) < 0.9), torch.full((q, k), INF),
        torch.full((q, k), -1, dtype=torch.int32), k=k)
    keep = g.integers(0, k + 1, q)
    cut = torch.from_numpy(np.arange(k)[None, :] >= keep[:, None])
    cut[:3 * e] = True
    bd = torch.where(cut, INF, full_d)
    bi = torch.where(cut, -1, full_i).to(torch.int32)
    if e:
        valid[3 * e:4 * e] = False
        bd[3 * e:4 * e] = t(edge_lists(e, k, seed))
        bi[3 * e:4 * e] = torch.arange(e * k, dtype=torch.int32).view(e, k)
    return (t(qx), t(qy), t(cx), t(cy), t(cids), t(valid), bd.contiguous(),
            bi.contiguous())


# (k, W): B1's wide queue at the window=1024 session's row; the wide merge
# at the hybrid k = 384 session's row and at the k=512 session's
_B1_WIDE = [(32, 1024), (384, 256), (512, 256)]


@pytest.mark.parametrize("precision", ["fp32", "mixed"])
@pytest.mark.parametrize("k,w", _B1_WIDE)
def test_b1_clean_rows_are_the_merge_and_the_sort(k, w, precision):
    """On clean rows with ascending lists the plain B1 equals route 2's
    mirror and the full sort of ``list ++ window`` cut to k, bit for bit."""
    args = b1_inputs(16, w, k, seed=k + w)
    plain = fused_scan_merge_ref(*args, k=k, precision=precision)
    assert _bits_equal(route2_mirror(args, k, precision), plain)
    assert _bits_equal(full_sort(args, k, precision), plain)
    # the edge lists and the partly filled rows are there
    assert torch.isinf(plain[0]).any() and torch.isfinite(plain[0]).any()


def _one_row(args, r):
    return tuple(a[r:r + 1].clone() for a in args)


@pytest.mark.parametrize("case", ["nan", "negative zero", "unsorted list"])
def test_b1_merge_needs_its_votes(case):
    """Each of the wide merge's votes sends a row the mirror gets wrong to
    the wide template: a NaN window entry (with n_valid >= k the plain
    version's radius is NaN and empties the row), a -0 list entry (the
    rounds emit it with its sign, the key as +0) and a list out of
    order."""
    k, w = 384, 256
    args = b1_inputs(16, w, k, seed=7)
    r = 6  # a full bucket-edge list, its window empty
    row = list(_one_row(args, r))
    assert torch.isfinite(row[6]).all()
    if case == "nan":
        row[5][0, 3] = True
        row[2][0, 3] = float("nan")
    elif case == "negative zero":
        row[6][0, 0] = -0.0
    else:
        row[6][0, :k // 2] = row[6][0, :k // 2].flip(0).clone()
        row[7][0, :k // 2] = row[7][0, :k // 2].flip(0).clone()
    row = tuple(row)
    plain = fused_scan_merge_ref(*row, k=k)
    mirror = route2_mirror(row, k)
    assert not _bits_equal(mirror, plain)
    if case == "negative zero":  # the sign of the zero alone differs
        assert same_values(mirror[0], plain[0])
        assert torch.equal(mirror[1], plain[1])


def b3_inputs(q, ka, kb, seed, inf_ids=True):
    """Two (Q, ka) and (Q, kb) lists, each ascending by (d2, id), made with
    numpy from ``seed``: distances on a coarse grid in the first rows (ties
    across the lists), exact (d2, id) duplicates across the lists, partly
    filled lists padded with (inf, id) for any id (still ascending for the
    kernels), and rows with negative entries and -inf."""
    g = np.random.default_rng(seed)
    out = []
    for c in (ka, kb):
        d = g.uniform(0, 4.0e6, (q, c)).astype(np.float32)
        i = g.integers(0, 1 << 30, (q, c), dtype=np.int32)
        out.append([d, i])
    (da, ia), (db, ib) = out
    e = max(1, q // 8)
    da[:e] = np.floor(da[:e] / 5.0e5) * 5.0e5
    db[:e] = np.floor(db[:e] / 5.0e5) * 5.0e5
    m = min(ka, kb)
    db[e:2 * e, :m], ib[e:2 * e, :m] = da[e:2 * e, :m], ia[e:2 * e, :m]
    da[3 * e:4 * e] -= 2.0e6
    da[3 * e:4 * e, :3] = -INF
    for d, i in out:
        order = np.lexsort((i, d), axis=1)
        d[:] = np.take_along_axis(d, order, 1)
        i[:] = np.take_along_axis(i, order, 1)
        fill = g.integers(0, d.shape[1] + 1, q)
        empty = np.arange(d.shape[1])[None, :] >= fill[:, None]
        empty[:2 * e] = False
        empty[3 * e:] = False
        empty[2 * e:3 * e] = np.arange(d.shape[1])[None, :] >= \
            fill[2 * e:3 * e, None]
        d[empty] = INF
        if not inf_ids:
            i[empty] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(da), t(ia), t(db), t(ib)


@pytest.mark.parametrize("ka,kb,k", [(384, 384, 384), (300, 300, 600),
                                     (600, 0, 32), (20, 700, 32)])
def test_b3_ascending_lists_are_the_co_rank_merge(ka, kb, k):
    """On two ascending lists without a NaN the plain B3 equals route 3's
    co-rank merge, bit for bit: ties across the lists, exact duplicates,
    (inf, id) padding, negative entries and -inf."""
    lists = b3_inputs(16, ka, kb, seed=ka + kb + k)
    plain = merge_topk_lists_ref(*lists, k=k)
    assert _bits_equal(route3_mirror(*lists, k=k), plain)
    if ka:
        assert torch.isneginf(plain[0]).any()


def test_b3_lone_nan_in_the_first_column_is_merged():
    """A NaN in a[0] alone: the rounds emit (NaN, INT_MAX) first and mask
    column 0, so the rest is the merge of a[1:] and b."""
    da, ia, db, ib = b3_inputs(16, 384, 384, seed=3)
    da[:, 0] = float("nan")
    plain = merge_topk_lists_ref(da, ia, db, ib, k=384)
    assert torch.isnan(plain[0][:, 0]).all()
    assert (plain[1][:, 0] == 2 ** 31 - 1).all()
    assert _bits_equal(route3_mirror(da, ia, db, ib, k=384), plain)


@pytest.mark.parametrize("case", ["nan", "negative zero", "unsorted list"])
def test_b3_merge_needs_its_votes(case):
    """A NaN past column 0 (the rounds then emit (NaN, INT_MAX) k times)
    and a list out of order make route 3's mirror wrong, so the kernel's
    vote sends such rows to the wide template.  A -0 needs no vote: the
    merge emits it as +0, equal in value, and every id equal, as from
    every key path (select_keys.cuh)."""
    k = 384
    da, ia, db, ib = (x[2:3].clone() for x in b3_inputs(16, k, k, seed=5))
    if case == "nan":
        da[0, k // 2] = float("nan")
    elif case == "negative zero":
        da[0, 0] = -0.0
    else:
        da[0, :k // 2] = da[0, :k // 2].flip(0).clone()
        ia[0, :k // 2] = ia[0, :k // 2].flip(0).clone()
    plain = merge_topk_lists_ref(da, ia, db, ib, k=k)
    mirror = route3_mirror(da, ia, db, ib, k=k)
    assert not _bits_equal(mirror, plain)
    if case == "negative zero":
        assert same_values(mirror[0], plain[0])
        assert torch.equal(mirror[1], plain[1])
