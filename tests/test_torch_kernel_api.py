"""Parity: the port's kernel API (B4, B5, B6) and ``find_kdist`` against JAX.

On the CPU each wrapper runs its kernel's plain version; the JAX ops run
their Pallas kernels in interpret mode, as the reference's own tests run
them, and ``find_kdist`` jitted.  Comparisons are bitwise (``np.array_equal``
on the raw bits, tolerance 0).  The reference's ``pairwise_dist_ref`` and
``bucket_kselect_ref`` are not the oracles here: called eagerly they compute
``dx*dx + dy*dy`` unfused, while the kernels compute ``fma(dx, dx, dy*dy)``.

B5 and ``find_kdist`` count the rank below a bucket against its edges (the
port's rule, ROADMAP §C), so they equal the reference on every row where the
reference keeps its guarantee ``count(valid & d2 < r) >= min(k, n_valid)``,
and keep it on every row, including the constructed edge rows on which the
reference does not.  The CUDA kernels are held against the plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.core.kselect import find_kdist as jax_find_kdist
import repro_torch.kernels as tk
from repro_torch.core.kselect import find_kdist
from repro_torch.kernels import bucket_kselect as tbk
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import topk_select as ttk
from repro_torch.kernels.refine import masked_argmin_rounds

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import edge_window, topk_inputs, worst_rows  # noqa: E402

torch.set_num_threads(2)


def _bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t(x):
    return torch.tensor(np.asarray(x))


def _data(q, c, seed, coincide=0):
    """The reference's kernel-test data: uniform on [0, 1000), 10% invalid;
    optionally the first ``coincide`` candidates on one spot."""
    rng = np.random.default_rng(seed)
    qpos = rng.uniform(0, 1000, (q, 2)).astype(np.float32)
    ppos = rng.uniform(0, 1000, (c, 2)).astype(np.float32)
    ppos[1:coincide] = ppos[0]
    valid = rng.random(c) < 0.9
    return qpos, ppos, valid


def _guarantee(d2, r, valid, k):
    """Per row: count(valid & d2 < r) >= min(k, n_valid)."""
    nv = valid.sum(-1)
    return ((d2 < r[:, None]) & valid).sum(1) >= np.minimum(k, nv)


@pytest.mark.parametrize("q,c", [(1, 1), (8, 128), (20, 300), (64, 1024),
                                 (7, 130)])
def test_pairwise_dist_matches_jax(q, c):
    qpos, ppos, valid = _data(q, c, seed=q * 1000 + c)
    want = jk.pairwise_dist_op(qpos, ppos, valid, interpret=True)
    before = tpd.pairwise_dist.launches
    got = tk.pairwise_dist_op(_t(qpos), _t(ppos), _t(valid))
    assert tpd.pairwise_dist.launches == before  # the CPU never launches
    _bits_equal(want, got.numpy())
    assert np.isinf(got.numpy()[:, ~valid]).all()
    # the plain version is the kernel's form, fma(dx, dx, dy*dy)
    ref = tk.pairwise_dist_ref(*(_t(a) for a in (qpos[:, 0], qpos[:, 1],
                                                 ppos[:, 0], ppos[:, 1],
                                                 valid)))
    _bits_equal(want, ref.numpy())
    # no mask: every candidate valid
    _bits_equal(jk.pairwise_dist_op(qpos, ppos, interpret=True),
                tk.pairwise_dist_op(_t(qpos), _t(ppos)).numpy())


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("q,c", [(64, 64), (30, 257)])
def test_topk_select_matches_jax(q, c, k):
    """Ids too, bit for bit: ties across ids, bf16-rounded distances, +inf
    entries, rows with fewer than k finite entries, no finite entry, exact
    (d2, id) duplicates, zeros of both signs (the edge bands of
    ``chip_smoke.topk_inputs``)."""
    d, i = topk_inputs(q, c, k, "cpu", seed=q + c + k)
    want = jk.topk_select_op(d.numpy(), i.numpy(), k=k, interpret=True)
    before = ttk.topk_select.launches
    got = tk.topk_select_op(d, i, k=k)
    assert ttk.topk_select.launches == before
    _bits_equal(want[0], got[0].numpy(), "distances")
    _bits_equal(want[1], got[1].numpy(), "ids")
    # and the reference's oracle, the two-key sort (ops.topk_select_ref)
    ref = jk.topk_select_ref(jnp.asarray(d.numpy()), jnp.asarray(i.numpy()),
                             k=k)
    two = tk.topk_select_ref(d, i, k=k)
    _bits_equal(ref[0], two[0].numpy())
    _bits_equal(ref[1], two[1].numpy())
    _bits_equal(want[1], two[1].numpy())


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("kind", ["descending", "equal"])
def test_topk_select_worst_rows_match_jax(kind, k):
    """``chip_smoke.worst_rows``, on which every entry enters a warp-queue
    select (each key below all before it), bit for bit against JAX."""
    d, i = worst_rows(16, 100, kind, "cpu", seed=k)
    assert ((d[:, 1:] < d[:, :-1])
            | ((d[:, 1:] == d[:, :-1]) & (i[:, 1:] < i[:, :-1]))).all()
    want = jk.topk_select_op(d.numpy(), i.numpy(), k=k, interpret=True)
    got = tk.topk_select_op(d, i, k=k)
    _bits_equal(want[0], got[0].numpy(), "distances")
    _bits_equal(want[1], got[1].numpy(), "ids")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_topk_select_sweep_matches_jax(dtype):
    """The reference's sweep data (``tests/test_kernels.py``): positional ids,
    distances rounded through ``dtype``; k up to C."""
    rng = np.random.default_rng(5)
    d2 = np.asarray(jnp.asarray(rng.uniform(0, 100, (30, 257)))
                    .astype(dtype).astype(jnp.float32))
    ids = np.tile(np.arange(257, dtype=np.int32)[None], (30, 1))
    for k in (1, 8, 32, 257, 300):
        want = jk.topk_select_op(d2, ids, k=k, interpret=True)
        got = tk.topk_select_op(_t(d2), _t(ids), k=k)
        _bits_equal(want[0], got[0].numpy(), f"k={k}")
        _bits_equal(want[1], got[1].numpy(), f"k={k}")


def test_topk_select_with_infs():
    d2 = _t(np.array([[1.0, np.inf, 0.5, np.inf]], np.float32))
    ids = _t(np.array([[10, 11, 12, 13]], np.int32))
    out_d, out_i = tk.topk_select_op(d2, ids, k=3)
    assert out_i[0].tolist() == [12, 10, -1]
    assert out_d[0, 2] == float("inf")


def _nan_closed_form(d, ids, k):
    """The rounds' output on rows holding a NaN, from how they behave: a NaN
    makes the row minimum NaN, no entry ties with it, so a round emits
    (NaN, INT_MAX) and masks column 0.  A row whose only NaN is column 0
    gives (NaN, INT_MAX), then the k - 1 smallest (d2, id) of columns 1 to
    C - 1 ((inf, -1) padded); any other NaN row (NaN, INT_MAX) k times."""
    q, c = d.shape
    out_d = np.full((q, k), np.inf, np.float32)
    out_i = np.full((q, k), -1, np.int32)
    out_d[:, 0], out_i[:, 0] = np.nan, np.iinfo(np.int32).max
    for r in range(q):
        if np.isnan(d[r, 1:]).any():
            out_d[r], out_i[r] = np.nan, np.iinfo(np.int32).max
            continue
        order = np.lexsort((ids[r, 1:], d[r, 1:]))[:k - 1]
        out_d[r, 1:1 + len(order)] = d[r, 1:][order]
        out_i[r, 1:1 + len(order)] = np.where(np.isinf(d[r, 1:][order]), -1,
                                              ids[r, 1:][order])
    return out_d, out_i


def _nan_bits_equal(a, b, what, zero_sign=True):
    """Bitwise, but a NaN equals any NaN (its payload is not part of the
    contract) and, without ``zero_sign``, -0 equals +0 (the rounds' row
    minimum of two zeros may be either; the sorts keep the entry's own)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b), err_msg=what)
    a, b = np.where(nan, 0, a), np.where(nan, 0, b)
    if not zero_sign:
        a, b = a + np.float32(0), b + np.float32(0)  # -0 + 0 is +0
    _bits_equal(a, b, what)


@pytest.mark.parametrize("k", [1, 5, 43])
@pytest.mark.parametrize("where", ["first", "last", "both", "inner"])
def test_topk_select_nan_rows_closed_form(where, k):
    """The premise of the card's NaN rule: on rows holding a NaN (column 0
    only, column C - 1 only, both, two inner columns), the reference's op
    in interpret mode and the port's plain version both equal the closed
    form, with k below C and past it (C = 40).  Rows of every 4th are left
    without a NaN, and some hold -inf, -0 and ties."""
    c = 40
    d, ids = topk_inputs(16, c, 8, "cpu", seed=k)
    d, ids = d.numpy(), ids.numpy()
    cols = {"first": [0], "last": [c - 1], "both": [0, c - 1],
            "inner": [c // 3, 2 * c // 3]}[where]
    nan_rows = np.arange(16) % 4 != 0
    for j in cols:
        d[nan_rows, j] = np.nan
    d[1::4, c // 2] = -np.inf
    d[2::4, c // 4] = -0.0
    want = jk.topk_select_op(d, ids, k=k, interpret=True)
    got = tk.topk_select_op(_t(d), _t(ids), k=k)
    closed = _nan_closed_form(d[nan_rows], ids[nan_rows], k)
    for name, out in (("reference", want), ("port", got)):
        out = [np.asarray(o) for o in out]
        _nan_bits_equal(out[0][nan_rows], closed[0], f"{name} distances",
                        zero_sign=False)
        _bits_equal(out[1][nan_rows], closed[1], f"{name} ids")
    _nan_bits_equal(want[0], got[0].numpy(), "distances", zero_sign=False)
    _bits_equal(want[1], got[1].numpy(), "ids")


def test_topk_select_wide_k_matches_two_sort():
    """The radix select's premise at k beyond the warp queue (C = 3000,
    k = 300): the port's plain version is bitwise equal to the reference's
    jitted two-key sort, ``topk_select_ref``, on ``topk_inputs``' edge rows
    (distances up to the sign of a zero: the sort keeps each entry's own,
    the rounds' row minimum may be either)."""
    d, ids = topk_inputs(16, 3000, 300, "cpu", seed=18)
    want = jax.jit(jk.topk_select_ref, static_argnames="k")(
        jnp.asarray(d.numpy()), jnp.asarray(ids.numpy()), k=300)
    got = ttk.topk_select(d, ids, k=300)
    _nan_bits_equal(want[0], got[0].numpy(), "distances", zero_sign=False)
    _bits_equal(want[1], got[1].numpy(), "ids")


def test_topk_select_wrapper_checks():
    d, i = topk_inputs(8, 40, 4, "cpu")
    with pytest.raises(ValueError, match="Q_TILE"):
        ttk.topk_select(d[:7].contiguous(), i[:7].contiguous(), k=4)
    with pytest.raises(ValueError, match="ids"):
        ttk.topk_select(d, i.to(torch.int64), k=4)
    with pytest.raises(ValueError, match="k and C"):
        ttk.topk_select(d, i, k=0)
    # the plain version of B4 is masked_argmin_rounds
    got = ttk.topk_select(d, i, k=4)
    want = masked_argmin_rounds(d, i, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


_KS = [1, 4, 16, 64, 200]


@pytest.mark.parametrize("k", _KS)
@pytest.mark.parametrize("q,c,coincide", [(8, 128, 0), (17, 333, 0),
                                          (64, 256, 40), (8, 5000, 40)])
def test_bucket_kselect_matches_jax(q, c, coincide, k):
    qpos, ppos, valid = _data(q, c, seed=k + c, coincide=coincide)
    want = np.asarray(jk.bucket_kselect_op(qpos, ppos, valid, k=k,
                                           interpret=True))
    before = tbk.bucket_kselect.launches
    got = tk.bucket_kselect_op(_t(qpos), _t(ppos), _t(valid), k=k).numpy()
    assert tbk.bucket_kselect.launches == before
    d2 = np.asarray(jk.pairwise_dist_op(qpos, ppos, valid, interpret=True))
    ref_ok = _guarantee(d2, want, valid, k)
    assert _guarantee(d2, got, valid, k).all()
    _bits_equal(want[ref_ok], got[ref_ok])
    if valid.sum() < k:
        assert np.isinf(got).all()
    # the plain version, called directly, is what the wrapper ran
    ref = tk.bucket_kselect_ref(*(_t(a) for a in (qpos[:, 0], qpos[:, 1],
                                                  ppos[:, 0], ppos[:, 1],
                                                  valid)), k=k)
    _bits_equal(got, ref.numpy())


@pytest.mark.parametrize("k", [4, 64])
@pytest.mark.parametrize("case", ["query", "window", "invalid_window",
                                  "few_valid"])
def test_bucket_kselect_nan_rows_match_jax(case, k):
    """A NaN distance makes the row's radius NaN, as ``jnp.min`` /
    ``jnp.max`` propagate it, unless the window holds fewer than k valid
    entries (+inf): NaN queries (some rows), a valid NaN candidate (every
    row), an invalid one (no row: its distance is +inf), and a NaN among
    three valid candidates.  The port equals the reference through the ops,
    NaN where it is NaN (a NaN's payload aside), and elsewhere bit for bit
    where the reference keeps its guarantee."""
    qpos, ppos, valid = _data(24, 128, seed=7 + k)
    if case == "query":
        qpos[::3, 0] = np.nan
    elif case in ("window", "invalid_window"):
        ppos[5] = np.nan
        valid[5] = case == "window"
    else:
        valid[:] = False
        valid[:3] = True
        ppos[1, 1] = np.nan
    want = np.asarray(jk.bucket_kselect_op(qpos, ppos, valid, k=k,
                                           interpret=True))
    got = tk.bucket_kselect_op(_t(qpos), _t(ppos), _t(valid), k=k).numpy()
    d2 = np.asarray(jk.pairwise_dist_op(qpos, ppos, valid, interpret=True))
    nan_row = np.isnan(d2).any(1)
    assert nan_row.any() == (case != "invalid_window")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(got),
                                  nan_row & (valid.sum() >= k))
    fin = ~np.isnan(want)
    ref_ok = fin & _guarantee(np.where(np.isnan(d2), np.inf, d2), want,
                              valid, k)
    _bits_equal(want[ref_ok], got[ref_ok])
    assert _guarantee(d2, got, valid, k)[~nan_row].all()


@pytest.mark.parametrize("k", _KS)
def test_find_kdist_matches_jax(k):
    """Per-row masks (some rows under k valid, one with none)."""
    qpos, ppos, valid = _data(48, 256, seed=k, coincide=30)
    d2 = np.asarray(jk.pairwise_dist_op(qpos, ppos, interpret=True))
    rng = np.random.default_rng(k)
    vm = rng.random(d2.shape) < 0.9
    vm[::5, 20:] = False  # 20 valid at most
    vm[3] = False
    want = np.asarray(jax.jit(jax_find_kdist, static_argnames=(
        "k", "num_bins", "iters"))(d2, vm, k=k))
    got = find_kdist(_t(d2), _t(vm), k=k).numpy()
    ref_ok = _guarantee(d2, want, vm, k)
    assert _guarantee(d2, got, vm, k).all()
    _bits_equal(want[ref_ok], got[ref_ok])
    assert np.isinf(got[vm.sum(1) < k]).all()


@pytest.mark.parametrize("k", [8, 32, 64])
def test_bucket_edge_window_keeps_the_guarantee(k):
    """A window of exactly k distances whose first-round bucket edge is a
    distance that the division bins one bucket lower
    (``chip_smoke.edge_window``).  The reference's B5 and ``find_kdist``
    count it twice and return a radius with only k-1 distances below it;
    the port counts against the edge and encloses all k."""
    qpos, ppos = edge_window(k, seed=k)
    valid = np.ones(k, bool)
    d2 = tk.pairwise_dist_op(_t(qpos), _t(ppos), _t(valid)).numpy()
    r_ref = np.asarray(jk.bucket_kselect_op(qpos, ppos, valid, k=k,
                                            interpret=True))
    r = tk.bucket_kselect_op(_t(qpos), _t(ppos), _t(valid), k=k).numpy()
    assert (d2 < r_ref[:, None]).sum() == k - 1  # the reference's fault
    assert (d2 < r[:, None]).sum() == k
    vm = np.ones_like(d2, bool)
    f_ref = np.asarray(jax_find_kdist(d2, vm, k=k))
    f = find_kdist(_t(d2), _t(vm), k=k).numpy()
    assert (d2 < f_ref[:, None]).sum() == k - 1
    assert (d2 < f[:, None]).sum() == k
    _bits_equal(r, f)  # one rule, one radius


def test_bucket_kselect_under_k_valid_is_inf():
    qpos, ppos, valid = _data(16, 128, seed=1)
    valid[:] = False
    valid[:5] = True
    r = tk.bucket_kselect_op(_t(qpos), _t(ppos), _t(valid), k=6).numpy()
    want = np.asarray(jk.bucket_kselect_op(qpos, ppos, valid, k=6,
                                           interpret=True))
    assert np.isinf(r).all()
    _bits_equal(want, r)


def test_bucket_kselect_wrapper_checks():
    qpos, ppos, valid = (_t(a) for a in _data(8, 64, seed=2))
    qx, qy = qpos[:, 0].contiguous(), qpos[:, 1].contiguous()
    px, py = ppos[:, 0].contiguous(), ppos[:, 1].contiguous()
    with pytest.raises(ValueError, match="Q_TILE"):
        tbk.bucket_kselect(qx[:7], qy[:7], px, py, valid, k=4)
    with pytest.raises(ValueError, match="valid"):
        tbk.bucket_kselect(qx, qy, px, py, valid.to(torch.int32), k=4)
    with pytest.raises(ValueError, match="k and C"):
        tbk.bucket_kselect(qx, qy, px[:0], py[:0], valid[:0], k=4)
    with pytest.raises(ValueError, match="C_TILE|multiples"):
        tpd.pairwise_dist(qx, qy, px, py, valid)  # C = 64 is not padded


def test_exports_follow_the_reference():
    """The kernel package exports the reference's kernel API names."""
    names = {"bucket_kselect_op", "pairwise_dist_op", "topk_select_op",
             "fused_scan_merge_op", "merge_topk_lists_op",
             "multi_merge_lists_op", "MIXED_WIDEN", "mixed_prune_keep",
             "bucket_kselect_ref", "merge_topk_lists_ref",
             "pairwise_dist_ref", "topk_select_ref", "tree_merge_lists"}
    assert names <= set(tk.__all__) & set(jk.__all__)
    assert tk.MIXED_WIDEN == jk.MIXED_WIDEN
