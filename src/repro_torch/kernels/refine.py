"""Plain PyTorch selection-round helpers (counterpart of ``repro/kernels/refine.py``).

``bucket_refine_step`` is one round of the Alabi bucket refinement with its
float-edge guard; ``masked_argmin_rounds`` materializes ascending ``(d2, id)``
lists, lowest id on distance ties, ``(inf, -1)`` padded; ``mixed_prune_keep``
is the bf16 widened-radius prefilter of ``precision="mixed"``.  They are the
plain versions the kernels' CUDA code is held against, bit for bit.
"""
from __future__ import annotations

import torch

from ..runtime import fma

__all__ = ["MIXED_WIDEN", "bucket_refine_step", "masked_argmin_rounds",
           "mixed_prune_keep"]

_ID_BIG = torch.iinfo(torch.int32).max

# Widening of the mixed-precision prefilter's k-th boundary, the reference's
# value: d2 in bf16 takes at most five roundings at 2^-8 (two casts, two
# squares, one add), so d2_bf16 < d2_f32 * (1 + 6 * 2^-8) < d2_f32 * 1.0625.
MIXED_WIDEN = 1.0 + 2.0 ** -4


def mixed_prune_keep(dx, dy, kth):
    """bf16 widened-radius prefilter: (T, W) keep-mask over a window.

    ``dx``/``dy`` are the f32 coordinate deltas (cast to bf16 after the
    subtraction, so the error stays relative to the distance), ``kth`` the
    (T,) current k-th distance (``best_d[:, k-1]``; +inf keeps the whole
    window).  Each bf16 operation is rounded once, to nearest even, as the
    kernel's ``__hmul`` / ``__hadd`` do (a bf16 product is exact in f32, and
    a bf16 sum rounded through f32 is correctly rounded).  The comparison is
    inclusive, so an entry at exactly the k-th distance always survives;
    ``kth`` is widened by a multiply with an f32 tensor.  The reference's
    CPU program may keep excess precision in the bf16 arithmetic, so this
    mask need not equal its mask bit for bit: both are conservative, and the
    merged lists do not depend on which conservative mask is used.
    """
    dxb = dx.to(torch.bfloat16)
    dyb = dy.to(torch.bfloat16)
    d2b = (dxb * dxb + dyb * dyb).to(torch.float32)
    widen = torch.full((), MIXED_WIDEN, dtype=torch.float32, device=kth.device)
    return d2b <= (kth * widen)[:, None]


def masked_argmin_rounds(d: torch.Tensor, ids: torch.Tensor, k: int):
    """k rounds of masked row-argmin: (T, C) dists + ids -> ascending (T, k).

    ``d`` must have invalid entries pre-masked to +inf.  Each round takes the
    row minimum, then the lowest id among the tied columns, then the first
    such column (exact ``(d, id)`` duplicates come out one per round).
    """
    t, c = d.shape
    dd = d.clone()
    inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    id_big = torch.full((), _ID_BIG, dtype=ids.dtype, device=d.device)
    out_d = torch.empty((t, k), dtype=d.dtype, device=d.device)
    out_i = torch.empty((t, k), dtype=torch.int32, device=d.device)
    rows = torch.arange(t, device=d.device)
    for j in range(k):
        mval = dd.amin(dim=1)
        tied = dd == mval[:, None]
        mid = torch.where(tied, ids, id_big).amin(dim=1)
        win = tied & (ids == mid[:, None])
        # argmax has no bool overload; on uint8 it returns the first maximum
        hit = torch.argmax(win.to(torch.uint8), dim=1)
        out_d[:, j] = mval
        out_i[:, j] = torch.where(torch.isinf(mval), -1, mid).to(torch.int32)
        dd[rows, hit] = inf
    return out_d, out_i


def bucket_refine_step(d2, lo, hi, kth, num_bins: int):
    """Descend one histogram level toward the k-th element.

    d2: (T, C) population, invalid entries +inf; lo/hi: (T,) half-open
    interval holding the wanted element; kth: (T,) int32 its rank among the
    entries inside it.  The histogram (bins by division, as the reference
    computes them) picks a bucket; the bucket's edges are then
    ``fma(sel, width, lo)`` and ``+ width``.  A value can fall on one side
    of an edge by the division and on the other by the edge itself, so the
    rank below the new interval, and whether the interval still holds the
    wanted element, are counted against the edges themselves.  Where they do
    not hold, the interval is kept.

    The reference (``repro/kernels/refine.py:91``) takes the rank from the
    histogram; when an entry sits exactly on the new lower edge but was
    binned below it, the interval then tracks the wrong rank and the prune
    radius can fall below the k-th distance, so its merge drops list entries
    (a full list merged with an empty window can lose its k-th entry).  The
    outputs of the merge are the exact k smallest either way whenever the
    radius stays above the k-th distance, so this step changes no output of
    the reference that was right.

    ``torch.maximum`` propagates NaN like ``jnp.maximum`` (rows without any
    finite entry have ``lo = hi = inf``); the bin index is clamped in float
    before the int cast, with NaN mapped to 0 as XLA's saturating convert
    does.
    """
    width = torch.maximum((hi - lo) / num_bins,
                          torch.full_like(lo, 1e-30))
    b = torch.floor((d2 - lo[:, None]) / width[:, None])
    b = torch.nan_to_num(b, nan=0.0).clamp(0, num_bins - 1).to(torch.int64)
    in_range = (d2 >= lo[:, None]) & (d2 < hi[:, None])
    hist = torch.zeros((d2.shape[0], num_bins), dtype=torch.int32,
                       device=d2.device)
    hist.scatter_add_(1, b, in_range.to(torch.int32))
    cum = torch.cumsum(hist, dim=1, dtype=torch.int32)
    sel = torch.argmax((cum >= kth[:, None]).to(torch.uint8), dim=1)
    new_lo = fma(sel.to(lo.dtype), width, lo)
    new_hi = new_lo + width
    below = ((d2 >= lo[:, None]) & (d2 < new_lo[:, None])).sum(
        dim=1, dtype=torch.int32)
    inside = ((d2 >= new_lo[:, None]) & (d2 < new_hi[:, None])).sum(
        dim=1, dtype=torch.int32)
    ok = (below < kth) & (below + inside >= kth)
    return (
        torch.where(ok, new_lo, lo),
        torch.where(ok, new_hi, hi),
        torch.where(ok, kth - below, kth),
    )
