"""Per-row top-k smallest of a (Q, C) distance tile: the result lists.

Replaces the Pallas TPU kernel ``repro/kernels/topk_select.py::topk_select``
(``pl.pallas_call`` at ``topk_select.py:49``) with the hand-written Hopper
kernel ``csrc/topk_select.cu``.  Its output is the k smallest ``(d2, id)``
pairs of each row, ascending, lowest id on distance ties, ``(inf, -1)``
padded; the plain version is
:func:`~repro_torch.kernels.refine.masked_argmin_rounds`.

The kernel is a warp-queue select (WarpSelect): one warp streams a row in
32-wide slabs and keeps the best ``W`` keys so far in a sorted warp queue
(``W`` = 32, 64, 128 or 256, the first at or above ``min(k, C)``); entries
below the queue's k-th key wait in a shared ring and are merged in by a
warp bitonic merge 32 at a time.  Its key is ``(d2, id)`` with ``-0`` and
``+0`` equal, as the rounds compare them; a zero distance leaves as
``+0``.  Where ``min(k, C)`` exceeds 256 it runs k rounds of a
lexicographic warp argmin instead.  Rows wider than 2048 columns (S3's
window is 2048, the kernel micro-benchmark's 1024) take the wide
template: one thread block a row, sorting the row's keys or running the
rounds in shared memory where the row fits and the rounds from global
memory beyond (``csrc/block_select.cuh``), so no width raises; the entry
point says which template it took.

:func:`topk_select` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors.  ``topk_select.launches`` counts kernel
launches, ``topk_select.wide_launches`` those of the wide template.
"""
from __future__ import annotations

import ctypes

import torch

from .refine import masked_argmin_rounds

__all__ = ["topk_select", "Q_TILE"]

Q_TILE = 8

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("topk_select.cu")
        lib.topk_select_f32.restype = ctypes.c_int
        lib.topk_select_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2)
        _lib = lib
    return _lib


def _check(d2, ids, k):
    dev = d2.device
    for name, t, dtype in (("d2", d2, torch.float32),
                           ("ids", ids, torch.int32)):
        if t.device != dev:
            raise ValueError(f"topk_select: {name} is on {t.device}, d2 on "
                             f"{dev}")
        if t.dtype != dtype or t.dim() != 2 or t.shape != d2.shape:
            raise ValueError(f"topk_select: {name} must be {dtype} "
                             f"{tuple(d2.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"topk_select: {name} must be contiguous")
    q, c = d2.shape
    if q % Q_TILE:
        raise ValueError(f"topk_select: Q={q} is not a multiple of "
                         f"Q_TILE={Q_TILE} (topk_select_op pads)")
    if k < 1 or c < 1:
        raise ValueError(f"topk_select: k and C must be >= 1, got k={k}, "
                         f"C={c}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_select: unsupported device {dev}")
    return q, c, dev


def topk_select(d2, ids, *, k: int):
    """(Q, C) f32 distances + (Q, C) i32 ids -> ((Q, k) f32, (Q, k) i32).

    Ascending ``(d2, id)``, lowest id on ties, ``(inf, -1)`` padded; +inf
    marks an empty entry.  ``Q`` must be a multiple of ``Q_TILE``.
    """
    q, c, dev = _check(d2, ids, k)
    if dev.type == "cpu":
        return masked_argmin_rounds(d2, ids, k)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    lib = _kernel()
    wide = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_select_f32(d2.data_ptr(), ids.data_ptr(),
                                  out_d.data_ptr(), out_i.data_ptr(), q, c, k,
                                  stream, ctypes.byref(wide))
    if err != 0:
        raise RuntimeError(f"topk_select: kernel launch failed with "
                           f"cudaError {err}")
    topk_select.launches += 1
    if wide.value:
        topk_select.wide_launches += 1
    return out_d, out_i


topk_select.launches = 0
topk_select.wide_launches = 0
