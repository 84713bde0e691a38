"""Fused distance + bucket k-selection radius against one shared window.

Replaces the Pallas TPU kernel ``repro/kernels/bucket_kselect.py::
bucket_kselect`` (``pl.pallas_call`` at ``bucket_kselect.py:84``) with the
hand-written Hopper kernel ``csrc/bucket_kselect.cu`` (a block stages the
window in shared memory once; one warp per query row keeps on chip only the
distances that can decide the refinement's rounds; see the source's
header).
It returns the (Q,) radius ``r`` with
``count(valid & d2 < r) >= min(k, n_valid)``, or +inf when the whole window
holds fewer than k valid candidates, or NaN where a valid distance of the
row is NaN (the reference's ``jnp.min`` propagates it).  A window of more
than 4096 candidates takes the kernel's wide template, which tiles it
through shared memory in slabs of 4096, so no width raises; the entry
point says which template it took.

The refinement counts ranks against the bucket edges, as the port's
:func:`~repro_torch.kernels.refine.bucket_refine_step` does, so on rows where
the reference's histogram rank double-counts an edge entry (and its radius
breaks the guarantee) the port's radius differs and keeps it; elsewhere the
two are equal bit for bit.  Bound on an H100: operations, about 17 f32 flops
per (query, candidate) pair at ``iters`` = 4.

:func:`bucket_kselect` launches the kernel for CUDA tensors (or raises) and
runs :func:`bucket_kselect_ref`, the plain PyTorch version, for CPU tensors.
``bucket_kselect.launches`` counts kernel launches,
``bucket_kselect.wide_launches`` those of the wide template.
"""
from __future__ import annotations

import ctypes

import torch

from ..runtime import fma
from .fused_scan import HI_ADD, HI_MUL, NUM_BINS, TINY
from .pairwise_dist import check_planes, pairwise_dist_ref
from .refine import bucket_refine_step

__all__ = ["bucket_kselect", "bucket_kselect_ref", "Q_TILE"]

Q_TILE = 8


def bucket_kselect_ref(qx, qy, px, py, valid, *, k: int,
                       num_bins: int = NUM_BINS, iters: int = 4):
    """Plain version: (Q,) queries x (C,) shared window -> (Q,) radius.

    The reference's compiled forms: ``d2 = fma(dx, dx, dy*dy)`` and
    ``hi = fma(max(hi0, lo), 1+1e-6, 1e-30)``; ``n_valid`` counts the whole
    window's valid entries.
    """
    d2 = pairwise_dist_ref(qx, qy, px, py, valid)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=qx.device)
    lo = d2.amin(dim=1)
    hi0 = torch.where(torch.isinf(d2), -inf, d2).amax(dim=1)
    hi = fma(torch.maximum(hi0, lo), torch.full_like(lo, HI_MUL),
             torch.full_like(lo, HI_ADD))
    kth = torch.full((qx.shape[0],), k, dtype=torch.int32, device=qx.device)
    for _ in range(iters):
        lo, hi, kth = bucket_refine_step(d2, lo, hi, kth, num_bins)
    return torch.where(valid.sum() < k, inf, hi)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("bucket_kselect.cu")
        lib.bucket_kselect_f32.restype = ctypes.c_int
        lib.bucket_kselect_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
        _lib = lib
    return _lib


def bucket_kselect(qx, qy, px, py, valid, *, k: int, num_bins: int = NUM_BINS,
                   iters: int = 4):
    """(Q,) queries x (C,) shared window -> (Q,) f32 k-selection radius.

    ``Q`` must be a multiple of ``Q_TILE``; on the card ``num_bins`` must
    be 32 (one bin per lane).
    """
    q, c, dev = check_planes("bucket_kselect", qx, qy, px, py, valid)
    if q % Q_TILE:
        raise ValueError(f"bucket_kselect: Q={q} is not a multiple of "
                         f"Q_TILE={Q_TILE} (bucket_kselect_op pads)")
    if k < 1 or c < 1:
        raise ValueError(f"bucket_kselect: k and C must be >= 1, got k={k}, "
                         f"C={c}")
    if dev.type == "cpu":
        return bucket_kselect_ref(qx, qy, px, py, valid, k=k,
                                  num_bins=num_bins, iters=iters)
    if num_bins != NUM_BINS:
        raise ValueError(f"bucket_kselect: the kernel has {NUM_BINS} bins, "
                         f"got num_bins={num_bins}")
    out = torch.empty((q,), dtype=torch.float32, device=dev)
    if q == 0:
        return out
    lib = _kernel()
    wide = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bucket_kselect_f32(qx.data_ptr(), qy.data_ptr(),
                                     px.data_ptr(), py.data_ptr(),
                                     valid.data_ptr(), out.data_ptr(), q, c,
                                     k, iters, HI_MUL, HI_ADD, TINY, stream,
                                     ctypes.byref(wide))
    if err != 0:
        raise RuntimeError(f"bucket_kselect: kernel launch failed with "
                           f"cudaError {err}")
    bucket_kselect.launches += 1
    if wide.value:
        bucket_kselect.wide_launches += 1
    return out


bucket_kselect.launches = 0
bucket_kselect.wide_launches = 0
