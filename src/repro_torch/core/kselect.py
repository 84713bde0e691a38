"""Bucket-based k-selection (Alabi et al.), the paper's Sec. 4.2.1 pillar.

Counterpart of ``repro/core/kselect.py::find_kdist``, the plain form of the
bucket k-selection with a per-row candidate mask: histogram each row's
distances into ``num_bins`` buckets over a shrinking ``[lo, hi)`` and descend
into the bucket holding the k-th one, without sorting.  Plain PyTorch, as the
reference's is jnp; the fused kernel over a shared window is
:mod:`repro_torch.kernels.bucket_kselect`.

The rounds are :func:`~repro_torch.kernels.refine.bucket_refine_step`, which
counts the rank below the chosen bucket against its edges.  The reference
takes that rank from the histogram, so an entry on a bucket edge that the
division bins below it is counted twice and its radius can fall under the
k-th distance; on such rows the port's radius differs and keeps the
guarantee, elsewhere the two are equal bit for bit.
"""
from __future__ import annotations

import torch

from ..kernels.fused_scan import HI_ADD, HI_MUL
from ..kernels.refine import bucket_refine_step
from ..runtime import fma

__all__ = ["find_kdist"]


def find_kdist(dist2: torch.Tensor, valid: torch.Tensor, *, k: int,
               num_bins: int = 32, iters: int = 4) -> torch.Tensor:
    """Per-row k-selection radius.

    ``dist2`` (Q, C) squared distances, ``valid`` (Q, C) bool mask of real
    candidates.  Returns the (Q,) radius ``r`` with
    ``count(valid & (dist2 < r)) >= min(k, count(valid))``: the upper edge
    of the bucket holding the k-th distance after ``iters`` refinements.
    Rows with fewer than k valid candidates return +inf.  Runs on the
    tensors' device.
    """
    inf = torch.full((), float("inf"), dtype=dist2.dtype, device=dist2.device)
    d = torch.where(valid, dist2, inf)
    n_valid = valid.sum(dim=1)
    lo = d.amin(dim=1)
    hi0 = torch.where(valid, dist2, -inf).amax(dim=1)
    hi = fma(torch.maximum(hi0, lo), torch.full_like(lo, HI_MUL),
             torch.full_like(lo, HI_ADD))
    kth = torch.full((d.shape[0],), k, dtype=torch.int32, device=d.device)
    for _ in range(iters):
        lo, hi, kth = bucket_refine_step(d, lo, hi, kth, num_bins)
    return torch.where(n_valid < k, inf, hi)
