"""Fused SCAN-step merge: distance + bucket prune + top-k, as one CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/fused_scan.py::fused_scan_merge``
(``pl.pallas_call`` at ``fused_scan.py:126``) with the hand-written Hopper
kernel ``csrc/fused_scan.cu`` (one warp per query row; see the source's
header for the design).  Because the refinement counts ranks against the
bucket edges, the merge of a row of squared distances is its exact
k-selection, so the kernel runs B4's warp queue (``csrc/select_keys.cuh``)
fed by the row's distances, and keeps the refinement, the prune and the
rounds for rows holding a NaN or a negative entry, and for k > 256.  Bound
on an H100: memory — per row it reads ``W*13 + k*8 + 8`` bytes and writes
``k*8``, about 31 MB per launch at Q=8192, W=256, k=32, so about 9.4 us at
3.35 TB/s.  The kernel keeps the (k+W) distance row and the queue on chip,
so only the window and the lists cross device memory.  A row wider than
the narrow templates' 512 (``k + W``) takes a wide route, so no width
raises; the kernel's entry point says which:

- **wide queue** (k <= 256): the warp queue over the whole row, 8 rows a
  block; the block's rows holding a NaN or a set sign bit (a negative
  entry, -inf or -0) then take the wide template one after another;
- **wide merge** (k > 256): one thread block a row; a row with no NaN and
  no set sign bit whose list is ascending is the list merged with the
  sorted window entries below its k-th key (``merged_at``); any other row
  takes the wide template in the same block;
- **wide template** (those rows, and every row where not even the list's
  k keys fit in shared memory): the plain version's refinement and prune
  at block level, then a sort of the kept entries' keys or the rounds
  (``csrc/block_select.cuh``).

:func:`fused_scan_merge` launches the kernel for CUDA tensors (or raises) and
runs :func:`fused_scan_merge_ref`, the plain PyTorch version, for CPU
tensors.  ``precision="mixed"`` first narrows the window by the bf16
widened-radius prefilter (:func:`~repro_torch.kernels.refine.mixed_prune_keep`,
the reference's branch at ``fused_scan.py:52``); the pruned entries leave the
refinement population too, and the merged lists equal fp32's bit for bit.
``fused_scan_merge.launches`` counts fp32 kernel launches,
``fused_scan_merge.mixed_launches`` the mixed ones,
``fused_scan_merge.wide_launches`` those of either past ``k + W = 512``,
and ``wide_queue_launches`` and ``wide_merge_launches`` those of them that
took the wide queue or the wide merge.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime import fma
from .refine import (MIXED_WIDEN, bucket_refine_step, masked_argmin_rounds,
                     mixed_prune_keep)

__all__ = ["fused_scan_merge", "fused_scan_merge_ref", "Q_TILE", "PRECISIONS"]

Q_TILE = 8
NUM_BINS = 32  # the kernel maps one bin to one lane

# The reference's f32 constants (Python floats rounded once to f32).
HI_MUL = float(np.float32(1 + 1e-6))
HI_ADD = float(np.float32(1e-30))
SLOP_MUL = float(np.float32(1e-6))
TINY = float(np.float32(1e-30))
PRECISIONS = ("fp32", "mixed")
# The C entry point's route codes past the narrow templates, and the
# counter each one adds to (code 1, the wide template, only to
# ``wide_launches``).
WIDE_ROUTES = {2: "wide_queue_launches", 3: "wide_merge_launches"}


def fused_scan_merge_ref(qx, qy, cx, cy, cids, valid, best_d, best_i, *,
                         k: int, num_bins: int = NUM_BINS, iters: int = 4,
                         precision: str = "fp32"):
    """Plain PyTorch version of the kernel, on any device.

    (Q,) queries x (Q, W) windows x (Q, k) ascending lists -> merged (Q, k)
    lists: the k smallest of the union, ascending ``(d2, id)``, ``(inf, -1)``
    padded.  The reference's compiled forms: ``d2 = fma(dx, dx, dy*dy)``,
    ``hi = fma(max(hi0, lo), 1+1e-6, 1e-30)``, ``fma(fhi, 1e-6, 1e-30)``.
    Under ``precision="mixed"`` the prefilter first drops window entries
    beyond the widened current k-th distance ``best_d[:, k-1]``.
    """
    q = qx.shape[0]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=qx.device)
    dx = cx - qx[:, None]
    dy = cy - qy[:, None]
    if precision == "mixed":
        valid = valid & mixed_prune_keep(dx, dy, best_d[:, k - 1])
    d2 = torch.where(valid, fma(dx, dx, dy * dy), inf)
    all_d = torch.cat([best_d, d2], dim=1)
    all_i = torch.cat([best_i, cids], dim=1)
    finite = ~torch.isinf(all_d)
    n_valid = finite.sum(dim=1)

    lo = all_d.amin(dim=1)
    hi0 = torch.where(finite, all_d, -inf).amax(dim=1)
    hi = fma(torch.maximum(hi0, lo), torch.full_like(lo, HI_MUL),
             torch.full_like(lo, HI_ADD))
    kth = torch.full((q,), k, dtype=torch.int32, device=qx.device)
    for _ in range(iters):
        lo, hi, kth = bucket_refine_step(all_d, lo, hi, kth, num_bins)
    slop = torch.maximum(hi - lo, fma(hi, torch.full_like(hi, SLOP_MUL),
                                      torch.full_like(hi, TINY)))
    radius = torch.where(n_valid < k, inf, hi + slop)
    d_sel = torch.where(all_d < radius[:, None], all_d, inf)
    return masked_argmin_rounds(d_sel, all_i, k)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("fused_scan.cu")
        lib.fused_scan_merge_f32.restype = ctypes.c_int
        lib.fused_scan_merge_f32.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 5
            + [ctypes.c_float] * 5
            + [ctypes.c_void_p] * 2
        )
        _lib = lib
    return _lib


def _check(qx, qy, cx, cy, cids, valid, best_d, best_i, k):
    q, w = cx.shape
    dev = qx.device
    expect = [
        ("qx", qx, torch.float32, (q,)), ("qy", qy, torch.float32, (q,)),
        ("cx", cx, torch.float32, (q, w)), ("cy", cy, torch.float32, (q, w)),
        ("cids", cids, torch.int32, (q, w)), ("valid", valid, torch.bool, (q, w)),
        ("best_d", best_d, torch.float32, (q, k)),
        ("best_i", best_i, torch.int32, (q, k)),
    ]
    for name, t, dtype, shape in expect:
        if t.device != dev:
            raise ValueError(f"fused_scan_merge: {name} is on {t.device}, "
                             f"qx on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"fused_scan_merge: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_scan_merge: {name} must be contiguous")
    if q % Q_TILE:
        raise ValueError(f"fused_scan_merge: Q={q} is not a multiple of "
                         f"Q_TILE={Q_TILE} (fused_scan_merge_op pads)")


def fused_scan_merge(qx, qy, cx, cy, cids, valid, best_d, best_i, *, k: int,
                     num_bins: int = NUM_BINS, iters: int = 4,
                     precision: str = "fp32"):
    """(Q,) queries x (Q, W) windows x (Q, k) lists -> merged (Q, k) lists.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`fused_scan_merge_ref`.  ``Q`` must be a multiple of ``Q_TILE``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"fused_scan_merge: precision must be one of "
                         f"{PRECISIONS}, got {precision!r}")
    _check(qx, qy, cx, cy, cids, valid, best_d, best_i, k)
    if qx.device.type == "cpu":
        return fused_scan_merge_ref(qx, qy, cx, cy, cids, valid, best_d,
                                    best_i, k=k, num_bins=num_bins,
                                    iters=iters, precision=precision)
    if qx.device.type != "cuda":
        raise ValueError(f"fused_scan_merge: unsupported device {qx.device}")
    if num_bins != NUM_BINS:
        raise ValueError(f"fused_scan_merge: the kernel has {NUM_BINS} bins, "
                         f"got num_bins={num_bins}")
    q, w = cx.shape
    mixed = precision == "mixed"
    lib = _kernel()
    out_d = torch.empty((q, k), dtype=torch.float32, device=qx.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=qx.device)
    if q == 0:
        return out_d, out_i
    route = ctypes.c_int(-1)
    with torch.cuda.device(qx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_scan_merge_f32(
            qx.data_ptr(), qy.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            cids.data_ptr(), valid.data_ptr(), best_d.data_ptr(),
            best_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            q, w, k, iters, int(mixed), HI_MUL, HI_ADD, SLOP_MUL, TINY,
            MIXED_WIDEN, stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"fused_scan_merge: kernel launch failed with "
                           f"cudaError {err}")
    if mixed:
        fused_scan_merge.mixed_launches += 1
    else:
        fused_scan_merge.launches += 1
    if route.value:
        fused_scan_merge.wide_launches += 1
    counter = WIDE_ROUTES.get(route.value)
    if counter:
        setattr(fused_scan_merge, counter,
                getattr(fused_scan_merge, counter) + 1)
    return out_d, out_i


fused_scan_merge.launches = 0
fused_scan_merge.mixed_launches = 0
fused_scan_merge.wide_launches = 0
fused_scan_merge.wide_queue_launches = 0
fused_scan_merge.wide_merge_launches = 0
