"""The premises of the wide routes of B1, B2, B3 and B5, on the CPU.

The wide merges of B1 (``csrc/fused_scan.cu``, k > 256), B2 and B3
(``csrc/merge_topk.cu``, ``merge_topk_multi`` and ``merge_topk_lists``
past a row of 512), and B5's staged route (``csrc/bucket_kselect.cu`` past
a window of 4096), rest on facts about the plain versions, which hold here
without a card:

- On a row with no NaN and no set sign bit whose list ascends under the
  ``(d2, id)`` key (+inf entries all equal), the plain B1 equals the list
  merged with the window entries whose key is below the list's k-th,
  sorted (route 2's mirror), and equals a full sort of ``list ++ window``
  cut to k, which is also what B1's wide queue keeps.
- On two ascending lists with no NaN, the plain B3 equals their co-rank
  merge (route 3's mirror), negative and -inf entries included, and with a
  lone NaN in the first list's first column emitted first.
- On R ascending lists of k with no NaN (but in column 0 of the first),
  the plain B2 equals their level merges (the wide merge's mirror); a row
  the vote flags (a later NaN, a list out of order) is the one it gets
  wrong.
- The votes are needed: a NaN and a list out of order make either mirror
  differ from the plain version; a -0 changes the sign of an output zero
  only, which B1's vote sends to the wide template and B2's and B3's
  merges leave as +0, as every key path does (``csrc/select_keys.cuh``).
- B5's row loop keeps the entries below a bin edge, up to CAP a warp, and
  runs the rounds on them where they serve: its mirror, at any CAP (the
  narrow 1024, the staged 2016, and 32, which overflows), equals the
  plain radius bit for bit.

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

from repro_torch.kernels.bucket_kselect import bucket_kselect_ref
from repro_torch.kernels.fused_scan import (HI_ADD, HI_MUL, NUM_BINS, TINY,
                                            fused_scan_merge_ref)
from repro_torch.kernels.merge_topk import (merge_topk_lists_ref,
                                            merge_topk_multi_ref)
from repro_torch.kernels.pairwise_dist import pairwise_dist_ref
from repro_torch.kernels.refine import mixed_prune_keep
from repro_torch.runtime import fma

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import edge_lists, edge_window, same_values  # noqa: E402

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


# ---- B2's wide merge (``merge_topk_multi`` past a row of 512)

def b2_vote(d, i, r, k):
    """The wide merge's vote on one row, as stage_vote takes each of its R
    lists: ``bad`` where an entry is NaN (but column 0 of the first list,
    which sets ``nan0``) or a list does not ascend under the staged key."""
    bad = nan0 = False
    for p in range(r):
        keys = [_key(float(x), int(y))
                for x, y in zip(d[p * k:(p + 1) * k], i[p * k:(p + 1) * k])]
        for j, key in enumerate(keys):
            if math.isnan(key[0]):
                if p == 0 and j == 0:
                    nan0 = True
                else:
                    bad = True
            elif j + 1 < k and keys[j + 1] < key:
                bad = True
    return bad, nan0


def level_merge_mirror(d, i, r, k):
    """B2's wide merge one row at a time: the R lists of k merged level by
    level (adjacent lists left before right, an odd tail carried, every
    merge cut to k) by the co-rank search; a NaN in column 0 leaves first
    as (NaN, INT_MAX) and the first list merges one entry shorter."""
    rows = []
    for row in range(d.shape[0]):
        keys = [_key(float(x), int(y)) for x, y in zip(d[row], i[row])]
        out = []
        if math.isnan(keys[0][0]):
            out.append((float("nan"), 2 ** 31 - 1))
        kk = k - len(out)
        lists = [keys[p * k:(p + 1) * k] for p in range(r)]
        lists[0] = lists[0][len(out):]
        while len(lists) > 2:
            level = [[merged_at(lists[2 * p], lists[2 * p + 1], t)
                      for t in range(kk)] for p in range(len(lists) // 2)]
            if len(lists) % 2:
                level.append(lists[-1][:kk])
            lists = level
        if len(lists) == 2:
            last = [merged_at(lists[0], lists[1], j) for j in range(kk)]
        else:
            last = lists[0][:kk]
        rows.append(out + [_pair(key) for key in last])
    return _rows_out(rows, k)


def b2_inputs(q, r, k, seed):
    """(Q, R * k) rows of R lists of k, each ascending by (d2, id), made
    with numpy from ``seed``, in bands of q // 8 rows: distances on a
    coarse grid (ties across the lists), exact (d2, id) duplicates across
    the lists, partly filled lists padded with (inf, id) for any id, one
    list empty, negative entries and -inf in the first list, and
    ``chip_smoke.edge_lists`` rows as the first list."""
    g = np.random.default_rng(seed)
    d = g.uniform(0, 4.0e6, (q, r, k)).astype(np.float32)
    i = g.integers(0, 1 << 30, (q, r, k), dtype=np.int32)
    e = max(1, q // 8)
    d[:e] = np.floor(d[:e] / 5.0e5) * 5.0e5
    d[e:2 * e, 1::2], i[e:2 * e, 1::2] = d[e:2 * e, :1], i[e:2 * e, :1]
    d[3 * e:4 * e, 0] -= 2.0e6
    d[3 * e:4 * e, 0, :3] = -INF
    d[5 * e:6 * e, 0] = edge_lists(e, k, seed)
    order = np.lexsort((i, d), axis=2)
    d = np.take_along_axis(d, order, 2)
    i = np.take_along_axis(i, order, 2)
    fill = g.integers(0, k + 1, (e, r))
    d[2 * e:3 * e][np.arange(k)[None, None, :] >= fill[:, :, None]] = INF
    d[4 * e:5 * e, r // 2] = INF
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.reshape(q, r * k)))
    return t(d), t(i)


# (R, k): object_sharded 8's row, odd R (a tail list carried), R = 1 with
# k past 512, and many short lists
_B2_WIDE = [(8, 128), (3, 200), (5, 130), (40, 32), (1, 600)]


@pytest.mark.parametrize("r,k", _B2_WIDE)
def test_b2_ascending_lists_are_the_level_merges(r, k):
    """On rows of R ascending lists without a NaN the vote passes every
    row and the plain B2 equals the level merges of the wide merge, bit
    for bit: ties across the lists, exact duplicates, (inf, id) padding,
    an empty list, negative entries and -inf."""
    d, i = b2_inputs(16, r, k, seed=r + k)
    assert not any(any(b2_vote(d[row], i[row], r, k)) for row in range(16))
    plain = merge_topk_multi_ref(d, i, k=k)
    assert _bits_equal(level_merge_mirror(d, i, r, k), plain)
    assert torch.isneginf(plain[0]).any() and torch.isinf(plain[0]).any()


@pytest.mark.parametrize("r,k", _B2_WIDE)
def test_b2_lone_nan_in_the_first_column_is_merged(r, k):
    """A NaN in column 0 alone: the vote sets nan0 only, and the rounds
    emit (NaN, INT_MAX) first and mask it, so the rest is the level merge
    of the other entries."""
    d, i = b2_inputs(16, r, k, seed=r * k)
    d[:, 0] = float("nan")
    assert all(b2_vote(d[row], i[row], r, k) == (False, True)
               for row in range(16))
    plain = merge_topk_multi_ref(d, i, k=k)
    assert torch.isnan(plain[0][:, 0]).all()
    assert (plain[1][:, 0] == 2 ** 31 - 1).all()
    assert _bits_equal(level_merge_mirror(d, i, r, k), plain)


@pytest.mark.parametrize("case", ["nan", "nan heading a later list",
                                  "unsorted list", "negative zero"])
def test_b2_merge_needs_its_votes(case):
    """Every row the vote sends to the wide template is one the level
    merges get wrong: a NaN past column 0 (the rounds then emit
    (NaN, INT_MAX) k times), in a later list's column 0 too, and a list out
    of order.  A -0 needs no vote: the merge emits it as +0, equal in
    value, and every id equal, as from every key path."""
    r, k = 8, 128
    d, i = (x[14:15].clone() for x in b2_inputs(16, r, k, seed=11))
    assert torch.isfinite(d).all()
    if case == "nan":
        d[0, k + 3] = float("nan")
    elif case == "nan heading a later list":
        d[0, 2 * k] = float("nan")
    elif case == "unsorted list":
        d[0, k:k + k // 2] = d[0, k:k + k // 2].flip(0).clone()
        i[0, k:k + k // 2] = i[0, k:k + k // 2].flip(0).clone()
    else:
        d[0, 0] = -0.0
    plain = merge_topk_multi_ref(d, i, k=k)
    mirror = level_merge_mirror(d, i, r, k)
    bad, nan0 = b2_vote(d[0], i[0], r, k)
    assert not nan0
    assert bad == (case != "negative zero")
    assert not _bits_equal(mirror, plain)
    if case == "negative zero":
        assert same_values(mirror[0], plain[0])
        assert torch.equal(mirror[1], plain[1])


# ---- B5's row loop past a window of 4096 (the staged route)

def _f(x):
    return torch.tensor([x], dtype=torch.float32)


def _bin_edge(m, flo, width):
    """bucket_kselect.cu's bin_edge: the least x whose quotient
    RN(RN(x - flo) / width) reaches m, from fma(m, width, flo) by one-ulp
    steps; None where 32 steps did not settle it."""
    def reaches(x):
        return bool(((x - flo) / width >= m).item())

    x = fma(_f(m), width, flo)
    if reaches(x):
        for _ in range(32):
            y = torch.nextafter(x, _f(-INF))
            if not reaches(y):
                return x
            x = y
        return None
    for _ in range(32):
        x = torch.nextafter(x, _f(INF))
        if reaches(x):
            return x
    return None


def _select(src, flo, fhi, width, kth):
    """The round's bucket from the histogram of src's entries in
    [flo, fhi): the plain version's binning, 0 where no bin reaches kth."""
    b = torch.floor((src - flo) / width)
    b = torch.nan_to_num(b, nan=0.0).clamp(0, NUM_BINS - 1).to(torch.int64)
    inr = (src >= flo) & (src < fhi)
    hist = torch.zeros(NUM_BINS, dtype=torch.int64).scatter_add_(
        0, b, inr.to(torch.int64))
    hit = torch.nonzero(torch.cumsum(hist, 0) >= kth)
    return float(hit[0, 0]) if hit.numel() else 0.0


def keep_rounds_mirror(x, k, cap, m_pred, iters=4):
    """One row of bucket_kselect_kernel<WARPS, CAP>: lo / hi (NaN if any
    entry is); at a round with nothing kept and a finite interval, the
    entries below bin_edge(m) kept, m from the warp's ``m_pred``, growing
    while too few reach kth and shrinking while more than ``cap``; the
    bucket chosen from the kept entries where there are some, the rank
    below it and its count against its edges over them where they hold all
    of [flo, new_hi), else over every entry; the bucket's entries kept for
    the next round where they fit.  Returns the final upper edge, the
    warp's next m_pred and the rounds the kept entries decided."""
    if bool(torch.isnan(x).any()):
        lo = hi0 = _f(float("nan"))
    else:
        lo = x.amin().reshape(1)
        hi0 = torch.where(torch.isinf(x), -INF, x).amax().reshape(1)
    fhi = fma(torch.maximum(hi0, lo), _f(HI_MUL), _f(HI_ADD))
    flo, kth = lo, k
    kept, kept_hi, served = None, None, []
    for _ in range(iters):
        width = torch.maximum((fhi - flo) / NUM_BINS, _f(TINY))
        finite = bool(torch.isfinite(torch.cat([flo, fhi, width])).all())
        if kept is None and finite:
            m, step = m_pred, 0
            while True:
                bound = fhi if m >= NUM_BINS else _bin_edge(m, flo, width)
                if bound is None:
                    break
                bound = torch.minimum(bound, fhi)
                sel = x[(x >= flo) & (x < bound)]
                n = sel.numel()
                if n <= cap and (n >= kth or bool(bound == fhi)):
                    kept, kept_hi = sel, bound
                    m_pred = (m // 2 if 1 < m < NUM_BINS and n >= 2 * kth
                              else m)
                    break
                if n > cap:
                    if step > 0 or m == 1:
                        break
                    step, m = -1, (16 if m >= NUM_BINS else m // 2)
                else:
                    if step < 0:
                        break
                    step, m = 1, (NUM_BINS if m >= 16 else m * 2)
        sel = _select(kept if kept is not None else x, flo, fhi, width, kth)
        new_lo = fma(_f(sel), width, flo)
        new_hi = new_lo + width
        from_kept = kept is not None and bool(new_hi <= kept_hi)
        served.append(from_kept)
        src = kept if from_kept else x
        below = int(((src >= flo) & (src < new_lo)).sum())
        inside = src[(src >= new_lo) & (src < new_hi)]
        if below < kth and below + inside.numel() >= kth:
            flo, fhi, kth = new_lo, new_hi, kth - below
            kept = inside if inside.numel() <= cap else None
            kept_hi = new_hi
        else:
            kept = None
    return fhi, m_pred, served


def b5_window(c, kind, seed, k=32):
    """Eight queries and a (C,) window made with numpy from ``seed``:
    ``uniform`` (``chip_smoke.window_inputs``' region, 10% invalid),
    ``coincident`` (its first 40 points on one spot, one query NaN and one
    at negative coordinates), or ``edge`` (``chip_smoke.edge_window``'s k
    distances, one query, padded to C with invalid candidates: their +inf
    distance changes neither lo nor hi nor any count)."""
    g = np.random.default_rng(seed)
    if kind == "edge":
        qpos, ppos = edge_window(k, seed)
        valid = np.arange(c) < len(ppos)
        ppos = np.concatenate([ppos, np.full((c - len(ppos), 2), 7.0,
                                             np.float32)])
    else:
        qpos = g.uniform(0, 22_500, (8, 2)).astype(np.float32)
        ppos = g.uniform(0, 22_500, (c, 2)).astype(np.float32)
        valid = g.random(c) >= 0.1
        if kind == "coincident":
            ppos[1:40] = ppos[0]
            qpos[1, 0] = np.nan
            qpos[2] *= -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(qpos[:, 0]), t(qpos[:, 1]), t(ppos[:, 0]), t(ppos[:, 1]),
            t(valid))


def _b5_mirror(args, k, cap):
    """The mirror over every row, one warp's m_pred carried from row to
    row, held bit for bit against the plain radius; returns each row's
    rounds decided by kept entries."""
    plain = bucket_kselect_ref(*args, k=k)
    n_valid = int(args[4].sum())
    rows, served, m_pred = [], [], 1
    for x in pairwise_dist_ref(*args):
        r, m_pred, s = keep_rounds_mirror(x, k, cap, m_pred)
        rows.append(_f(INF) if n_valid < k else r)
        served.append(s)
    got = torch.cat(rows)
    assert same_values(got, plain)
    fin = ~plain.isnan()
    assert torch.equal(got.view(torch.int32)[fin],
                       plain.view(torch.int32)[fin])
    return served


# kept entries a warp: the narrow kernel's, the staged route's, and one
# that overflows on almost every keeping pass
_CAPS = [1024, 2016, 32]


@pytest.mark.parametrize("cap", _CAPS)
@pytest.mark.parametrize("kind", ["uniform", "coincident"])
@pytest.mark.parametrize("k", [1, 32, 256, 2000])
@pytest.mark.parametrize("c", [5000, 16_384])
def test_b5_kept_entries_decide_the_rounds(c, k, kind, cap):
    """Past 4096 candidates the row loop keeps each row's entries below
    bin_edge(m), up to ``cap`` a warp, and runs the rounds on them: the
    mirror equals the plain radius bit for bit on uniform windows and on
    coincident points with a NaN and a negative query row, whether the
    keeping passes serve or overflow.  At C = 16,384 the first round's
    bucket (about C / 12 entries) passes the narrow kernel's 1024 on
    most rows and fits the staged route's 2016 where k <= 256."""
    served = _b5_mirror(b5_window(c, kind, seed=c + k), k, cap)
    first = [s[0] for s in served]
    if c == 16_384 and kind == "uniform":
        if cap == 1024:
            assert sum(first) <= len(first) // 4
        elif cap == 2016 and k <= 256:
            assert all(first)
    if cap >= 1024 and k <= 256:
        assert any(any(s) for s in served)


@pytest.mark.parametrize("cap", _CAPS)
@pytest.mark.parametrize("k", [8, 32, 256, 2000])
@pytest.mark.parametrize("c", [5000, 16_384])
def test_b5_kept_entries_on_bucket_edge_windows(c, k, cap):
    """The bucket-edge windows of ``test_bucket_edge_window_keeps_the_
    guarantee`` (k distances, the first round's last bucket edge itself a
    distance that the division bins one bucket lower) padded to C: the
    mirror equals the plain radius, which encloses all k distances."""
    args = b5_window(c, "edge", seed=k, k=k)
    _b5_mirror(args, k, cap)
    r = bucket_kselect_ref(*args, k=k)
    assert int((pairwise_dist_ref(*args) < r[:, None]).sum()) == k
