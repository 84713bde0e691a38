"""Per-row top-k smallest of a (Q, C) distance tile: the result lists.

Replaces the Pallas TPU kernel ``repro/kernels/topk_select.py::topk_select``
(``pl.pallas_call`` at ``topk_select.py:49``) with the hand-written Hopper
kernel ``csrc/topk_select.cu``.  Its output is the k smallest ``(d2, id)``
pairs of each row, ascending, lowest id on distance ties, ``(inf, -1)``
padded; the plain version is
:func:`~repro_torch.kernels.refine.masked_argmin_rounds`.

The kernel has three templates, picked from ``C`` and ``k`` only; the C
entry point reports which one ran:

- **queue** (``min(k, C) <= 256`` and ``C <= 2048``): a warp-queue select
  (WarpSelect).  One warp streams a row in 32-wide slabs and keeps the best
  ``W`` keys so far in a sorted warp queue (``W`` = 32, 64, 128 or 256, the
  first at or above ``min(k, C)``); entries below the queue's k-th key wait
  in a shared ring and are merged in by a warp bitonic merge 32 at a time.
- **radix** (every other shape): one thread block a row, a radix select of
  the row's 64-bit ``(d2, id)`` keys.  Each pass histograms the next digit
  (up to 8 bits, d2's first) of the keys under the decided prefix in 256
  shared bins, and skips the digits all those keys share; it stops once
  the bin holding rank k holds no more keys than are still needed.  Then
  the keys below the k-th are gathered, sorted and stored.  Ids are read
  only for entries on the k-th distance and for the winners.  Where the
  row's d2 fits in shared memory (C up to about 57,000 at k = 32 on an
  H100) it is staged once by bulk asynchronous copies; beyond, every pass
  reads it from global memory.
- **global** (``min(k, C)`` past about 28,000, where the k keys do not fit
  in shared memory): the block rounds over global memory
  (``csrc/block_select.cuh``).

A row holding a NaN is written in closed form, as the rounds leave it:
``(NaN, INT_MAX)`` first, then the k - 1 smallest of columns 1 to C - 1
where column 0 is the row's only NaN, else ``(NaN, INT_MAX)`` k times.
The key is ``(d2, id)`` with ``-0`` and ``+0`` equal, as the rounds
compare them; a zero distance leaves as ``+0``.  No width raises.

:func:`topk_select` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors.  ``topk_select.launches`` counts kernel
launches; ``queue_launches``, ``radix_launches`` and ``global_launches``
those of each template, and ``wide_launches`` those past the warp queue
(radix or global).
"""
from __future__ import annotations

import ctypes

import torch

from .refine import masked_argmin_rounds

__all__ = ["topk_select", "Q_TILE"]

Q_TILE = 8
# The C entry point's route codes: the template each launch took.
ROUTES = ("queue", "radix", "global")

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
    route = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.topk_select_f32(d2.data_ptr(), ids.data_ptr(),
                                  out_d.data_ptr(), out_i.data_ptr(), q, c, k,
                                  stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"topk_select: kernel launch failed with "
                           f"cudaError {err}")
    counter = f"{ROUTES[route.value]}_launches"
    setattr(topk_select, counter, getattr(topk_select, counter) + 1)
    topk_select.launches += 1
    if route.value != 0:
        topk_select.wide_launches += 1
    return out_d, out_i


topk_select.launches = 0
topk_select.wide_launches = 0
topk_select.queue_launches = 0
topk_select.radix_launches = 0
topk_select.global_launches = 0
