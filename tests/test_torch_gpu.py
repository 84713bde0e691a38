"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, where there is no
CUDA card.  On a machine with one (JAX is not needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import bucket_kselect as tbk
from repro_torch.kernels import fused_scan as tfs
from repro_torch.kernels import merge_topk as tmt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import topk_select as ttk
from repro_torch.kernels.ops import _lex_sort_merge, topk_select_ref
from repro_torch.kernels.refine import masked_argmin_rounds
from repro_torch.runtime import fma

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (_guarantee, edge_window, kernel_inputs,  # noqa: E402
                        merge_inputs, odd_rows, same_values, topk_inputs,
                        window_inputs, worst_rows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run this file on the GPU machine")
    return torch.device("cuda")


# (k, W): the queue's rungs (N = 1, 2, 4, 8), the rounds template (k > 256),
# and the main path's row (k = 32, W = 256)
_B1_SHAPES = [(1, 64), (8, 64), (32, 64), (32, 256), (33, 31), (64, 448),
              (100, 156), (200, 56), (256, 256), (300, 100), (480, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,w", _B1_SHAPES)
def test_fused_scan_kernel_matches_plain_and_exact(cuda, k, w):
    """Bitwise equal to the plain version on every row of
    ``chip_smoke.kernel_inputs`` (bucket-edge lists, lists in any order, NaN
    window and list entries with n_valid on both sides of k, negative
    entries, -inf and -0), and to the exact two-sort merge on the rows
    inside its premise."""
    args = kernel_inputs(256, w, k, cuda, seed=k + w)
    before = tfs.fused_scan_merge.launches
    out_d, out_i = tfs.fused_scan_merge(*args, k=k)
    ref_d, ref_i = tfs.fused_scan_merge_ref(*args, k=k)
    torch.cuda.synchronize()
    assert tfs.fused_scan_merge.launches == before + 1
    assert torch.equal(out_d, ref_d) and torch.equal(out_i, ref_i)
    qpos = torch.stack(args[:2], 1)
    cpos = torch.stack(args[2:4], 2)
    lex_d, lex_i = _lex_sort_merge(qpos, cpos, *args[4:], k)
    ok = ~odd_rows(256, cuda)
    assert torch.equal(out_d[ok], lex_d[ok]) and torch.equal(out_i[ok],
                                                             lex_i[ok])
    # a NaN with n_valid >= k empties the row, as in JAX
    e = 256 // 16
    n_valid = (~torch.isinf(args[6])).sum(1) + args[5].sum(1)
    full = torch.zeros(256, dtype=torch.bool, device=cuda)
    full[7 * e:8 * e] = n_valid[7 * e:8 * e] >= k
    assert torch.isinf(out_d[full]).all() and (out_i[full] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k,w", [(8, 64), (32, 256), (100, 156)])
def test_fused_scan_kernel_equals_topk_select_of_its_row(cuda, k, w):
    """On rows of squared distances, B1 is B4 over ``list ++ window d2``:
    the two kernels share one warp queue."""
    args = kernel_inputs(256, w, k, cuda, seed=k, odd=False)
    qx, qy, cx, cy, cids, valid, bd, bi = args
    dx, dy = cx - qx[:, None], cy - qy[:, None]
    d2 = torch.where(valid, fma(dx, dx, dy * dy),
                     torch.full_like(dx, float("inf")))
    row_d = torch.cat([bd, d2], 1).contiguous()
    row_i = torch.cat([bi, cids], 1).contiguous()
    assert _same(tfs.fused_scan_merge(*args, k=k),
                 ttk.topk_select(row_d, row_i, k=k))


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("r,k", [(1, 8), (2, 20), (3, 20), (4, 32), (5, 12),
                                 (8, 32), (3, 33), (5, 100), (1, 512)])
def test_merge_topk_multi_kernel_matches_plain_and_two_sort(cuda, r, k):
    """B2, bitwise, on ``chip_smoke.merge_inputs``'s edge rows (pairs equal
    across lists, lists of unequal fill, (inf, id) padding); R odd and even,
    k not a power of two, and a row whose shared memory passes 48 KB."""
    d, i = merge_inputs(r, 1024, k, cuda, seed=r, inf_ids=True)
    d_cat = d.transpose(0, 1).reshape(1024, r * k).contiguous()
    i_cat = i.transpose(0, 1).reshape(1024, r * k).contiguous()
    before = tmt.merge_topk_multi.launches
    out = tmt.merge_topk_multi(d_cat, i_cat, k=k)
    torch.cuda.synchronize()
    assert tmt.merge_topk_multi.launches == before + 1
    assert _same(out, tmt.merge_topk_multi_ref(d_cat, i_cat, k=k))
    assert _same(out, topk_select_ref(d_cat, i_cat, k))


@pytest.mark.gpu
def test_merge_kernels_take_zeros_of_both_signs(cuda):
    """B2 and B3 find -0 and +0 equal, as the plain version does: the lower
    id goes first whatever the signs."""
    d_a = torch.tensor([[-0.0, -0.0, 1.0, 2.0]] * 8, device=cuda)
    i_a = torch.tensor([[6, 9, 5, 1]] * 8, device=cuda, dtype=torch.int32)
    d_b = torch.tensor([[0.0, 0.0, -0.0, 3.0]] * 8, device=cuda)
    i_b = torch.tensor([[3, 7, 8, 2]] * 8, device=cuda, dtype=torch.int32)
    d_cat, i_cat = torch.cat([d_a, d_b], 1), torch.cat([i_a, i_b], 1)
    want = masked_argmin_rounds(d_cat, i_cat, 6)
    assert want[1][0].tolist() == [3, 6, 7, 8, 9, 5]
    assert _same(tmt.merge_topk_lists(d_a, i_a, d_b, i_b, k=6), want)
    assert _same(tmt.merge_topk_multi(d_cat, i_cat, k=4),
                 masked_argmin_rounds(d_cat, i_cat, 4))


@pytest.mark.gpu
def test_merge_topk_multi_kernel_needs_whole_lists(cuda):
    """On the card the row must be R whole lists of k."""
    d, i = merge_inputs(3, 64, 8, cuda)
    d_cat = d.transpose(0, 1).reshape(64, 24).contiguous()
    i_cat = i.transpose(0, 1).reshape(64, 24).contiguous()
    with pytest.raises(ValueError, match="whole lists"):
        tmt.merge_topk_multi(d_cat, i_cat, k=7)


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb,k", [(32, 32, 32), (20, 32, 32), (8, 8, 12),
                                     (40, 12, 32), (12, 40, 32), (7, 50, 33),
                                     (0, 9, 8), (256, 256, 512)])
def test_merge_topk_lists_kernel_matches_plain_and_two_sort(cuda, ka, kb, k):
    """B3, bitwise, lists narrower and wider than k, k wider than the row,
    an empty list, k = 512 (over 48 KB of shared memory), on
    ``chip_smoke.merge_inputs``' edge rows."""
    d, i = merge_inputs(2, 1024, max(ka, kb), cuda, seed=ka + kb,
                        inf_ids=True)
    args = (d[0, :, :ka].contiguous(), i[0, :, :ka].contiguous(),
            d[1, :, :kb].contiguous(), i[1, :, :kb].contiguous())
    before = tmt.merge_topk_lists.launches
    out = tmt.merge_topk_lists(*args, k=k)
    torch.cuda.synchronize()
    assert tmt.merge_topk_lists.launches == before + 1
    assert _same(out, tmt.merge_topk_lists_ref(*args, k=k))
    two = topk_select_ref(torch.cat([args[0], args[2]], 1),
                          torch.cat([args[1], args[3]], 1), k)
    # the two-sort merge is as wide as the row when k exceeds it
    assert _same(tuple(o[:, :two[0].shape[1]] for o in out), two)


@pytest.mark.gpu
@pytest.mark.parametrize("k,w", _B1_SHAPES)
def test_fused_scan_mixed_kernel_matches_plain_and_fp32(cuda, k, w):
    """B1's mixed branch, bitwise equal to its plain mixed version on every
    row and to the fp32 kernel on the rows inside the prefilter's premise
    (``chip_smoke.odd_rows``), counted as a mixed launch."""
    args = kernel_inputs(256, w, k, cuda, seed=k + w)
    before = (tfs.fused_scan_merge.launches,
              tfs.fused_scan_merge.mixed_launches)
    out = tfs.fused_scan_merge(*args, k=k, precision="mixed")
    ref = tfs.fused_scan_merge_ref(*args, k=k, precision="mixed")
    torch.cuda.synchronize()
    assert (tfs.fused_scan_merge.launches,
            tfs.fused_scan_merge.mixed_launches) == (before[0],
                                                      before[1] + 1)
    assert _same(out, ref)
    fp32 = tfs.fused_scan_merge(*args, k=k)
    ok = ~odd_rows(256, cuda, mixed=True)
    assert _same((out[0][ok], out[1][ok]), (fp32[0][ok], fp32[1][ok]))


def _xy(pos):
    return pos[:, 0].contiguous(), pos[:, 1].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("q,c", [(8, 128), (7, 130), (64, 1024),
                                 (2048, 100_000)])
def test_pairwise_dist_kernel_matches_plain(cuda, q, c):
    """B6 through its op (Q padded to 8, C to 128), bitwise."""
    qpos, ppos, valid = window_inputs(q, c, cuda, seed=q + c)
    before = tpd.pairwise_dist.launches
    out = tops.pairwise_dist_op(qpos, ppos, valid)
    ref = tpd.pairwise_dist_ref(*_xy(qpos), *_xy(ppos), valid)
    torch.cuda.synchronize()
    assert tpd.pairwise_dist.launches == before + 1
    assert same_values(out, ref)


@pytest.mark.gpu
def test_pairwise_dist_kernel_takes_unaligned_inputs(cuda):
    """Candidate planes that start off a 16-byte boundary are copied to an
    aligned buffer before the float4 loads."""
    qpos, ppos, valid = window_inputs(16, 257, cuda, seed=3)
    qx, qy = _xy(qpos)
    px, py = _xy(ppos)
    px, py, v = px[1:129], py[1:129], valid[1:129]
    out = tpd.pairwise_dist(qx, qy, px, py, v)
    assert same_values(out, tpd.pairwise_dist_ref(qx, qy, px, py, v))


def _odd_band(d, seed=0):
    """Rows 0-3 of every 16 get a NaN (in column 0, in a later column, in
    both), a -inf and a -0 in place: masked_argmin_rounds' NaN, -inf and
    signed-zero rounds, on a copy of ``d``."""
    d = d.clone()
    q, c = d.shape
    nan = float("nan")
    d[0::16, 0] = nan
    d[1::16, c // 2] = nan
    d[2::16, 0] = nan
    d[2::16, c - 1] = nan
    d[3::16, c // 3] = -float("inf")
    d[3::16, c // 4] = -0.0
    d[4::16] -= 1.0e6  # negative entries
    return d.contiguous()


def _same_nan(a, b):
    return same_values(a[0], b[0]) and torch.equal(a[1], b[1])


def _b4_template(c, k):
    """The template B4's entry point takes: the warp queue up to 2048
    columns and min(k, C) = 256, the block rounds where min(k, C) keys pass
    the card's 227 KB of shared memory, else the radix select."""
    m = min(k, c)
    if c <= 2048 and m <= 256:
        return "queue"
    return "global" if 8 * m > 227 * 1024 else "radix"


def _b4_launch(fn, c, k):
    """fn() launches B4 once; asserts the template it took."""
    counts = ("launches", f"{_b4_template(c, k)}_launches")
    before = [getattr(ttk.topk_select, n) for n in counts]
    out = fn()
    torch.cuda.synchronize()
    assert [getattr(ttk.topk_select, n) for n in counts] == [
        b + 1 for b in before]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,k", [
    (1024, 288, 32), (256, 2048, 32), (64, 40, 1), (64, 100, 64), (61, 33, 8),
    (64, 1, 1), (64, 1, 32), (128, 300, 31), (128, 300, 33),
    (128, 1000, 64), (64, 2048, 1), (64, 70, 128), (64, 2048, 256),
    (64, 200, 300), (64, 2000, 300), (64, 2048, 512), (64, 1000, 1000),
    (64, 700, 900)])
def test_topk_select_kernel_matches_plain_and_two_sort(cuda, q, c, k):
    """B4 through its op, ids too, on ``chip_smoke.topk_inputs``' edge rows
    (descending rows, one d2 with descending ids, duplicates in other
    slabs, zeros of both signs): every rung of the warp-queue ladder,
    k > C, k = C, C = 1, C not a multiple of 32, and min(k, C) beyond the
    ladder (the radix select); then again with NaN, -inf, -0 and negative
    rows, against masked_argmin_rounds."""
    d, i = topk_inputs(q, c, k, cuda, seed=c + k)
    out = _b4_launch(lambda: tops.topk_select_op(d, i, k=k), c, k)
    assert _same(out, masked_argmin_rounds(d, i, k))
    two = topk_select_ref(d, i, k)
    assert _same(tuple(o[:, :two[0].shape[1]] for o in out), two)
    odd = _odd_band(d)
    out = _b4_launch(lambda: tops.topk_select_op(odd, i, k=k), c, k)
    assert _same_nan(out, masked_argmin_rounds(odd, i, k))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["descending", "equal"])
@pytest.mark.parametrize("c,k", [(288, 32), (2048, 32), (300, 100),
                                 (8192, 32), (3000, 300)])
def test_topk_select_kernel_on_worst_rows(cuda, kind, c, k):
    """B4, bitwise, on rows where every entry enters the warp queue, and
    (``equal``: one d2 for the row) the radix select reaches the id
    digits; with and without NaN, -inf, -0 and negative rows."""
    d, i = worst_rows(64, c, kind, cuda, seed=c)
    for dd in (d, _odd_band(d)):
        out = _b4_launch(lambda: ttk.topk_select(dd, i, k=k), c, k)
        assert _same_nan(out, masked_argmin_rounds(dd, i, k))


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,k", [
    (64, 2049, 4), (64, 8192, 32), (64, 3000, 300), (32, 5000, 1),
    (16, 40_000, 32), (16, 30_000, 600), (16, 40_000, 300),
    (8, 60_000, 32), (16, 3000, 3000), (16, 12_000, 600),
    (8, 30_000, 30_000)])
def test_topk_select_wide_template_matches_plain(cuda, q, c, k):
    """B4 past its warp queue's 2048 columns: bitwise equal to
    masked_argmin_rounds on ``chip_smoke.topk_inputs``' edge rows and on
    NaN, -inf, -0 and negative rows; the row staged in shared memory, read
    from global memory (C = 60,000), and k's keys past shared memory (the
    block rounds, k = 30,000)."""
    d, i = topk_inputs(q, c, k, cuda, seed=c + k)
    for dd in (d, _odd_band(d)):
        before = ttk.topk_select.wide_launches
        out = _b4_launch(lambda: ttk.topk_select(dd, i, k=k), c, k)
        assert ttk.topk_select.wide_launches == before + 1
        assert _same_nan(out, masked_argmin_rounds(dd, i, k))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 256, 3000])
@pytest.mark.parametrize("c", [2048, 100, 4096])
def test_bucket_kselect_kernel_matches_plain(cuda, k, c):
    """B5 through its op (10% invalid, 40 coincident points, a band of NaN
    queries, a band at negative coordinates, an invalid NaN candidate),
    bitwise, NaN where the plain version is, and the guarantee on every row
    without a NaN distance; k = 3000 is more than a window of 2048 holds.
    C = 2048 and 100 hold the distances in registers, 4096 recomputes
    them."""
    qpos, ppos, valid = window_inputs(4099, c, cuda, seed=k + c)
    before = tbk.bucket_kselect.launches
    out = tops.bucket_kselect_op(qpos, ppos, valid, k=k)
    torch.cuda.synchronize()
    assert tbk.bucket_kselect.launches == before + 1
    qx, qy = _xy(qpos)
    px, py = _xy(ppos)
    assert same_values(out, tbk.bucket_kselect_ref(qx, qy, px, py, valid,
                                                 k=k))
    d2 = tpd.pairwise_dist_ref(qx, qy, px, py, valid)
    n_valid = int(valid.sum())
    assert _guarantee(d2, out, k, n_valid)
    assert torch.isnan(out).any() == (n_valid >= k)  # the NaN band
    if n_valid < k:
        assert torch.isinf(out).all()


def _skewed_window(cuda, kind, k, c):
    """B5 on one of the skewed windows, held bitwise against its plain
    version and, where no distance overflows, against its guarantee."""
    g = torch.Generator(device=cuda).manual_seed(k)
    q = 1024
    qpos = torch.rand((q, 2), generator=g, device=cuda) * 1000
    ppos = torch.rand((c, 2), generator=g, device=cuda) * 1000
    if kind == "far":
        ppos[k // 2 + 1:] += 1.0e5
    elif kind == "one_spot":
        ppos[:] = ppos[0]
    elif kind == "cluster":
        ppos = ppos * 0.05 + 500.0
    elif kind == "huge":
        qpos, ppos = qpos * 2.0e16, ppos * 2.0e16
    valid = torch.rand(c, generator=g, device=cuda) < 0.9
    out = tops.bucket_kselect_op(qpos, ppos, valid, k=k)
    ref = tbk.bucket_kselect_ref(*_xy(qpos), *_xy(ppos), valid, k=k)
    assert same_values(out, ref)
    if kind != "huge":
        d2 = tpd.pairwise_dist_ref(*_xy(qpos), *_xy(ppos), valid)
        assert _guarantee(d2, out, k, int(valid.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["far", "one_spot", "small", "cluster",
                                  "huge"])
@pytest.mark.parametrize("k", [1, 32, 256])
def test_bucket_kselect_kernel_on_skewed_windows(cuda, kind, k):
    """B5, bitwise, where its kept buckets do not serve and it takes the
    pass over every entry: the k-th distance in a high bin (all but a few
    candidates far away), one spot for the whole window (every entry in
    bin 0, more than 512 of them), a window that fits whole (C = 300), a
    cluster far smaller than the query region, and coordinates near 1e19
    (distances that overflow to +inf, an infinite first interval)."""
    _skewed_window(cuda, kind, k, 300 if kind == "small" else 2048)


def _b5_staged(c, k):
    """Whether B5 takes its staged route at window C and k: past 4096
    candidates, where the window fits in shared memory beside 10 warps'
    2016 kept entries each (C <= 16,725 on an H100's 232,448 bytes) and
    k <= 1008; else the wide template."""
    return 4096 < c <= 16_725 and k <= 1008


def _b5_wide_launch(qpos, ppos, valid, k):
    """B5 past its 4096-candidate window, counted once as wide and on the
    staged route where it takes it."""
    fn = tbk.bucket_kselect
    c = ppos.shape[0]
    before = (fn.launches, fn.wide_launches, fn.wide_staged_launches)
    out = tops.bucket_kselect_op(qpos, ppos, valid, k=k)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wide_launches, fn.wide_staged_launches) == (
        before[0] + 1, before[1] + 1, before[2] + _b5_staged(c, k))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["far", "one_spot", "cluster", "huge"])
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("c", [16_384, 25_000])
def test_bucket_kselect_wide_on_skewed_windows(cuda, kind, k, c):
    """The same skewed windows past 4096 candidates, on the staged route
    (C = 16,384) and the wide template (C = 25,000): every keeping pass
    overflows on one spot, the interval is infinite on the huge one."""
    before = tbk.bucket_kselect.wide_staged_launches
    _skewed_window(cuda, kind, k, c)
    assert tbk.bucket_kselect.wide_staged_launches == before + _b5_staged(c,
                                                                          k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("c", [16_384, 25_000])
def test_bucket_kselect_wide_on_a_bucket_edge_window(cuda, k, c):
    """The edge window padded to C candidates with invalid ones (their
    distance +inf changes neither lo nor hi nor any count): the wide
    routes equal the plain version and enclose all k."""
    qpos, ppos = (torch.tensor(a, device=cuda) for a in edge_window(k, k))
    ppos = torch.cat([ppos, torch.full((c - k, 2), 7.0, device=cuda)])
    valid = torch.arange(c, device=cuda) < k
    out = _b5_wide_launch(qpos, ppos, valid, k)
    ref = tbk.bucket_kselect_ref(*_xy(qpos), *_xy(ppos), valid, k=k)
    d2 = tpd.pairwise_dist_ref(*_xy(qpos), *_xy(ppos), valid)
    assert torch.equal(out, ref) and int((d2 < out[:, None]).sum()) == k


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 32])
def test_bucket_kselect_kernel_on_a_bucket_edge_window(cuda, k):
    """The constructed edge window on which the reference loses the k-th
    distance: the kernel equals the plain version and encloses all k."""
    qpos, ppos = (torch.tensor(a, device=cuda) for a in edge_window(k, k))
    valid = torch.ones(k, dtype=torch.bool, device=cuda)
    out = tops.bucket_kselect_op(qpos, ppos, valid, k=k)
    ref = tbk.bucket_kselect_ref(*_xy(qpos), *_xy(ppos), valid, k=k)
    d2 = tpd.pairwise_dist_ref(*_xy(qpos), *_xy(ppos), valid)
    assert torch.equal(out, ref) and int((d2 < out[:, None]).sum()) == k


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("c", [4097, 9000, 16_384, 16_725, 16_726, 25_000])
def test_bucket_kselect_wide_template_matches_plain(cuda, k, c):
    """B5 past its 4096-candidate window, on the staged route (up to
    C = 16,725, its last window on an H100) and the wide template past it,
    tiled through shared memory: bitwise equal to the plain version (NaN
    where it is, on the NaN query band and the negative band of
    ``chip_smoke.window_inputs``) and the guarantee on every row without a
    NaN distance."""
    _b5_wide_case(cuda, k, c)


@pytest.mark.gpu
@pytest.mark.parametrize("c,k", [(16_384, 1008), (16_725, 1008),
                                 (16_384, 1009), (16_384, 2000),
                                 (25_000, 2000)])
def test_bucket_kselect_wide_where_kept_entries_overflow(cuda, c, k):
    """k near the staged route's kept room: at k = 1008, its last k, the
    bins that reach rank k hold more than 1008 entries and some rows'
    keeping passes overflow 2016, so their rounds pass over every entry;
    past it (k = 1009 and 2000) the wide template takes the window."""
    _b5_wide_case(cuda, k, c)


def _b5_wide_case(cuda, k, c):
    """Without the odd bands and with them."""
    for odd in (False, True):
        qpos, ppos, valid = window_inputs(1027, c, cuda, seed=k + c, odd=odd)
        out = _b5_wide_launch(qpos, ppos, valid, k)
        qx, qy = _xy(qpos)
        px, py = _xy(ppos)
        assert same_values(out, tbk.bucket_kselect_ref(qx, qy, px, py, valid,
                                                     k=k))
        d2 = tpd.pairwise_dist_ref(qx, qy, px, py, valid)
        assert _guarantee(d2, out, k, int(valid.sum()))
        assert bool(torch.isnan(out).any()) == odd  # the NaN band


# (k, W) past the narrow templates' k + W <= 512: the main path's k with a
# wide window, k = 512 at window 256, a row past shared memory, the wide
# queue's last rung and the wide merge's first k, the hybrid session's row
_B1_WIDE = [(32, 1024), (512, 256), (1, 600), (300, 300), (33, 2000),
            (32, 30_000), (256, 1024), (257, 1024), (384, 256)]


def _b1_wide_route(k):
    """The counter of the wide route B1 takes at k: the wide queue up to
    the queue's 256, the wide merge above."""
    return "wide_queue_launches" if k <= 256 else "wide_merge_launches"


def _b1_wide_launch(args, k, precision="fp32"):
    """One B1 launch past the narrow row, held bitwise against the plain
    version and counted once as wide and once on its route."""
    fn = tfs.fused_scan_merge
    route = _b1_wide_route(k)
    before = (fn.wide_launches, getattr(fn, route))
    out = fn(*args, k=k, precision=precision)
    torch.cuda.synchronize()
    assert (fn.wide_launches, getattr(fn, route)) == (before[0] + 1,
                                                      before[1] + 1)
    assert _same(out, tfs.fused_scan_merge_ref(*args, k=k,
                                               precision=precision))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "mixed"])
@pytest.mark.parametrize("k,w", _B1_WIDE)
def test_fused_scan_wide_template_matches_plain(cuda, k, w, precision):
    """B1 past k + W = 512, fp32 and mixed, bitwise equal to the plain
    version on every band of ``chip_smoke.kernel_inputs`` (bucket-edge
    lists, lists in any order, NaN window and list entries, negative
    entries, -inf and -0), counted as a wide launch on its route: the
    wide queue for k <= 256, the wide merge above."""
    q = 256 if w < 10_000 else 32
    _b1_wide_launch(kernel_inputs(q, w, k, cuda, seed=k + w), k, precision)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "mixed"])
@pytest.mark.parametrize("k,w", [(32, 1024), (256, 300), (384, 256)])
def test_fused_scan_wide_routes_hand_rows_over(cuda, k, w, precision):
    """Blocks that mix rows each wide route takes with rows it hands to
    the wide template: one odd row among seven clean ones (a NaN window
    entry, a -0 list entry, a negative list), and lists out of order, all
    in one launch, bitwise equal to the plain version."""
    args = [a.clone() for a in kernel_inputs(32, w, k, cuda, seed=k,
                                             odd=False)]
    qx, qy, cx, cy, cids, valid, bd, bi = args
    valid[3, 7] = True  # block 0: one NaN window entry
    cx[3, 7] = float("nan")
    bd[10, 0] = -0.0  # block 1: a -0 as the list's first entry
    bd[21] = bd[21] - 1.0e6  # block 2: a negative list
    n = int(torch.isfinite(bd[25]).sum())  # block 3: a list out of order
    if n > 1:
        bd[25, :n] = bd[25, :n].flip(0).clone()
        bi[25, :n] = bi[25, :n].flip(0).clone()
    _b1_wide_launch(args, k, precision)


@pytest.mark.gpu
def test_fused_scan_wide_merge_survivors_past_shared_memory(cuda):
    """k = 300 at W = 30,000: the wide merge's shared room holds 16,384
    survivors, so rows with a short list (every valid window entry below
    its +inf k-th key) take the wide template over global memory in the
    same launch as the full lists' merges; bitwise equal to the plain
    version."""
    k, w = 300, 30_000
    args = list(kernel_inputs(8, w, k, cuda, seed=11, odd=False))
    full = tfs.fused_scan_merge_ref(*args, k=k)  # full lists: rows 0 to 3
    args[6][:4], args[7][:4] = full[0][:4], full[1][:4]
    args[6][4:] = float("inf")  # empty lists: rows 4 to 7
    args[7][4:] = -1
    assert torch.isfinite(args[6][:4]).all()
    _b1_wide_launch(args, k)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b1", "b3"])
def test_wide_template_past_the_merges_shared_room(cuda, kernel):
    """Where not even the keys a wide merge stages fit in the 227 KB of
    shared memory (B1's k = 29,000 list; B3's two lists of 15,000), the
    launch takes the wide template, counted as wide and on no route,
    bitwise equal to the plain version."""
    if kernel == "b1":
        k, fn = 29_000, tfs.fused_scan_merge
        args = kernel_inputs(8, 16, k, cuda, seed=5, odd=False)
        plain = lambda: tfs.fused_scan_merge_ref(*args, k=k)
        counters = ("wide_launches", "wide_queue_launches",
                    "wide_merge_launches")
    else:
        k, fn = 15_000, tmt.merge_topk_lists
        d, i = merge_inputs(2, 8, k, cuda, seed=5, inf_ids=True)
        args = (d[0], i[0], d[1], i[1])
        plain = lambda: tmt.merge_topk_lists_ref(*args, k=k)
        counters = ("wide_launches", "wide_merge_launches")
    before = [getattr(fn, c) for c in counters]
    out = fn(*args, k=k)
    torch.cuda.synchronize()
    assert [getattr(fn, c) for c in counters] == [before[0] + 1,
                                                   *before[1:]]
    assert _same(out, plain())


@pytest.mark.gpu
@pytest.mark.parametrize("r,k,q", [(8, 128, 1024), (3, 200, 1024),
                                   (1, 600, 256), (40, 32, 256),
                                   (250, 128, 16), (5, 130, 256)])
def test_merge_topk_multi_wide_template_matches_plain(cuda, r, k, q):
    """B2 past R * k = 512 (R = 8 at k = 128 is object_sharded 8's row; odd
    R carry a tail list; the (250, 128) row passes shared memory and takes
    the wide template, every other one the wide merge), bitwise equal to
    its plain version on ``chip_smoke.merge_inputs``' edge rows, on NaN
    (a lone one in column 0, which the wide merge takes, and later ones),
    -inf, -0 and negative rows, and on a list out of order, which the
    wide merge hands to the wide template."""
    d, i = merge_inputs(r, q, k, cuda, seed=r + k, inf_ids=True)
    d_cat = d.transpose(0, 1).reshape(q, r * k).contiguous()
    i_cat = i.transpose(0, 1).reshape(q, r * k).contiguous()
    # the last list out of order on rows 4 to 7 of every 16
    last = slice((r - 1) * k, r * k)
    perm = torch.argsort(torch.rand((q, k), device=cuda), dim=1)
    shuf = (torch.arange(q, device=cuda) % 16 // 4 == 1)[:, None]
    sd, si = d_cat.clone(), i_cat.clone()
    sd[:, last] = torch.where(shuf, torch.gather(d_cat[:, last], 1, perm),
                              d_cat[:, last])
    si[:, last] = torch.where(shuf, torch.gather(i_cat[:, last], 1, perm),
                              i_cat[:, last])
    merged = 0 if r == 250 else 1  # the wide merge's staged keys fit
    fn = tmt.merge_topk_multi
    for dd, ii in ((d_cat, i_cat), (_odd_band(d_cat), i_cat), (sd, si)):
        before = (fn.wide_launches, fn.wide_merge_launches)
        out = fn(dd, ii, k=k)
        torch.cuda.synchronize()
        assert (fn.wide_launches, fn.wide_merge_launches) == (
            before[0] + 1, before[1] + merged)
        assert _same_nan(out, tmt.merge_topk_multi_ref(dd, ii, k=k))


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb,k,q", [(384, 384, 384, 1024),
                                       (300, 300, 600, 256),
                                       (600, 0, 32, 256), (20, 700, 32, 256),
                                       (32, 32, 600, 256),
                                       (16_000, 16_000, 64, 16)])
def test_merge_topk_lists_wide_template_matches_plain(cuda, ka, kb, k, q):
    """B3 past a row of 512 (ka = kb = 384 is ``fused_merge`` at k = 384),
    past k = 512, and past shared memory, bitwise equal to its plain
    version on ``chip_smoke.merge_inputs``' edge rows, on NaN (a lone one
    in column 0, which the wide merge takes, and later ones), -inf, -0 and
    negative rows, and on a first list out of order; every launch takes
    the wide merge, which hands the rows it cannot merge over."""
    d, i = merge_inputs(2, q, max(ka, kb), cuda, seed=ka + kb + k,
                        inf_ids=True)
    da, ia = d[0, :, :ka].contiguous(), i[0, :, :ka].contiguous()
    db, ib = d[1, :, :kb].contiguous(), i[1, :, :kb].contiguous()
    cases = [(da, ia)]
    if ka:
        # and the first list out of order on rows 4 to 7 of every 16
        perm = torch.argsort(torch.rand((q, ka), device=cuda), dim=1)
        shuf = torch.zeros(q, dtype=torch.bool, device=cuda)
        shuf[4::16] = shuf[5::16] = shuf[6::16] = shuf[7::16] = True
        sd = torch.where(shuf[:, None], torch.gather(da, 1, perm), da)
        si = torch.where(shuf[:, None], torch.gather(ia, 1, perm), ia)
        cases += [(_odd_band(da), ia), (sd.contiguous(), si.contiguous())]
    fn = tmt.merge_topk_lists
    for a_d, a_i in cases:
        before = (fn.wide_launches, fn.wide_merge_launches)
        out = fn(a_d, a_i, db, ib, k=k)
        torch.cuda.synchronize()
        assert (fn.wide_launches, fn.wide_merge_launches) == (
            before[0] + 1, before[1] + 1)
        assert _same_nan(out, tmt.merge_topk_lists_ref(a_d, a_i, db, ib,
                                                        k=k))


@pytest.mark.gpu
def test_server_on_the_card_equals_a_solo_session(cuda):
    """A 20,000-object server on the card (three tenants, one with rows that
    duplicate another's, spatial invalidation) equals a solo session fed the
    same world, bitwise, on a build, an unchanged tick served from the cache
    and a delta tick; the solo session's ``TickHandle.done()`` turns true
    without a ``result()``."""
    import time

    import numpy as np

    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.data.generators import make_workload
    from repro_torch.serve import KnnServer

    n = 20_000
    spec = ServiceSpec(backend="fused_bucket")
    pos = make_workload(n, "uniform", seed=9, side=spec.side).positions()
    qid = np.arange(n, dtype=np.int32)
    srv = KnnServer(spec, invalidation="spatial")
    srv.ingest_objects(pos)
    tenants = [srv.admit(f"t{i}") for i in range(3)]
    rows = [qid[i::3] for i in range(3)] + [qid[1::3][:500]]
    groups = [t.register_queries(pos[r], r)
              for t, r in zip(tenants, rows[:3])]
    groups.append(tenants[0].register_queries(pos[rows[3]], rows[3]))
    solo = KnnSession(spec)
    solo.ingest_objects(pos)
    solo.register_queries(pos, qid)
    g = np.random.default_rng(1)
    for t in range(3):
        if t == 2:
            ids = g.choice(n, 100, replace=False).astype(np.int32)
            new = np.clip(pos[ids] + g.uniform(-200, 200, (ids.size, 2)), 0,
                          spec.side - 1e-3).astype(np.float32)
            tenants[1].update_objects(ids, new)
            solo.update_objects(ids, new)
        st = srv.submit()
        res = st.result()
        assert (res.inner is None) == (t == 1)
        h = solo.submit()
        deadline = time.monotonic() + 60.0
        while not h.done():
            assert time.monotonic() < deadline, "done() never turned true"
            time.sleep(0.001)
        ref = h.result()
        for group, r in zip(groups, rows):
            ii, dd, qq = st.result_for(group)
            assert np.array_equal(ii, ref.nn_idx[r])
            assert np.array_equal(dd.view(np.uint32),
                                  ref.nn_dist[r].view(np.uint32))
            assert np.array_equal(qq, r)


@pytest.mark.gpu
def test_network_engine_tick_on_the_card_equals_the_cpu(cuda):
    """Two ``TickEngine`` ticks (``fused_bucket``) over a 20,000-object road
    network on the card equal the same ticks on the CPU, bitwise: lists,
    iterations, candidates and rebuild decisions.  The second tick piles
    objects onto the network's nodes, where lists tie at distance 0."""
    import warnings

    import numpy as np

    from repro_torch.core import EngineConfig, TickEngine
    from repro_torch.data import make_workload

    out = []
    for device in ("cuda", "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            engine = TickEngine(EngineConfig(backend="fused_bucket"),
                                device=device)
        before = tfs.fused_scan_merge.launches
        out.append(engine.run(make_workload(20_000, "network", seed=4),
                              ticks=2))
        launched = tfs.fused_scan_merge.launches - before
        assert (launched >= 2) == (device == "cuda"), launched
    for rc, rp in zip(*out):
        assert np.array_equal(rc.nn_idx, rp.nn_idx)
        assert np.array_equal(rc.nn_dist.view(np.uint32),
                              rp.nn_dist.view(np.uint32))
        assert (rc.iterations, rc.candidates, rc.rebuilt) == (
            rp.iterations, rp.candidates, rp.rebuilt)


@pytest.mark.gpu
def test_property_draws_on_the_card(cuda):
    """One full-matrix draw and one n < k draw of the property harness
    (``repro_torch.properties``, the reference's first draw of each) on
    the card, ``fused_bucket`` with both kernel merges on the object-axis
    plans: every plan x partitioner x merge cell equals the ``single``
    plan's bits, the (-1, inf) padding included; B1, B2 and B3 launch."""
    from repro_torch import properties as P
    from repro_torch.testing import draws

    merges = ("fused_multi", "fused_merge")
    counters = (tfs.fused_scan_merge, tmt.merge_topk_multi,
                tmt.merge_topk_lists)
    before = [fn.launches for fn in counters]
    for name, run in (
            ("test_full_matrix_bit_identical", P.full_matrix),
            ("test_fewer_objects_than_k_all_plans", P.fewer_objects_than_k)):
        strats, _ = P.PROPERTIES[name]
        (draw,) = draws(name, strats, 1)
        *_, cells = run(*draw, device=cuda, backends=("fused_bucket",),
                        merges=merges)
        assert cells == 10, (name, cells)
    torch.cuda.synchronize()
    assert all(fn.launches > b for fn, b in zip(counters, before))
