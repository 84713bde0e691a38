"""Merge of ascending (d2, id) result lists: the object-axis plans' reduce.

Replaces two Pallas TPU kernels of ``repro/kernels/merge_topk.py`` with the
hand-written Hopper kernels of ``csrc/merge_topk.cu`` (see the source's
header for the design):

- :func:`merge_topk_multi` (``merge_topk_multi``, ``pl.pallas_call`` at
  ``merge_topk.py:75``): R per-shard lists of k for each query laid side by
  side in one (Q, R*k) row, reduced to (Q, k) in one launch
  (``merge="fused_multi"``);
- :func:`merge_topk_lists` (``merge_topk_lists``, ``pl.pallas_call`` at
  ``merge_topk.py:119``): the binary merge of a (Q, ka) and a (Q, kb) list,
  the step of the pairwise tree (``merge="fused_merge"``).

Both give the k smallest pairs of the row, ascending ``(d2, id)``, lowest id
on distance ties, ``(inf, -1)`` padded: the plain versions ``*_ref`` are
:func:`~repro_torch.kernels.refine.masked_argmin_rounds` over the row.

The kernels merge, they do not search: they rest on the reference's
precondition (``merge_topk.py:4``, ``:60``, ``:108``) that every input list
is ascending under ``(d2, id)`` with its +inf entries at the tail (any ids
on those), as every caller's lists are.  ``-0`` and ``+0`` count as equal,
as the plain version compares them, and a zero distance leaves as ``+0``.
A warp stages its row in shared memory; each output is found by a
merge-path co-rank binary search, and ``merge_topk_multi`` merges its R
lists pairwise in ceil(log2 R) levels.  A row wider than 512 entries (or
k above it) takes a wide route instead, so no width raises; the entry
point says which.  ``merge_topk_lists`` takes the wide merge: one thread
block a row merging the two lists by the same co-rank search, where both
whole lists ascend and hold no NaN (a lone NaN in the first list's first
column is emitted first, as the rounds emit it); any other row, and
``merge_topk_multi``'s wide rows, take the wide template: one thread
block a row sorting the row's keys in shared memory, or running the plain
version's rounds (``csrc/block_select.cuh``).  On the card ``merge_topk_multi`` needs the row to be R
whole lists of k (C % k == 0) and raises otherwise; the plain version on
the CPU takes any row.  Bound on an H100: memory,
``(row width + k) * 8`` bytes per row (about 0.385 ms for B2 at
Q = 1,007,616, R = 4, k = 32 at 3.35 TB/s).

CUDA tensors launch a kernel (or raise); CPU tensors run the plain
version.  Each wrapper counts its kernel launches in ``.launches``, and
those past the narrow row also in ``.wide_launches``;
``merge_topk_lists.wide_merge_launches`` counts those of them that took
the wide merge.
"""
from __future__ import annotations

import ctypes

import torch

from .refine import masked_argmin_rounds

__all__ = [
    "merge_topk_multi",
    "merge_topk_multi_ref",
    "merge_topk_lists",
    "merge_topk_lists_ref",
    "Q_TILE",
]

Q_TILE = 8


def merge_topk_multi_ref(d_cat, i_cat, *, k: int):
    """Plain version: (Q, C) concatenated lists -> (Q, k) k smallest pairs."""
    return masked_argmin_rounds(d_cat, i_cat, k)


def merge_topk_lists_ref(d_a, i_a, d_b, i_b, *, k: int):
    """Plain version: (Q, ka) + (Q, kb) lists -> (Q, k) k smallest pairs."""
    return masked_argmin_rounds(torch.cat([d_a, d_b], dim=1),
                                torch.cat([i_a, i_b], dim=1), k)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("merge_topk.cu")
        lib.merge_topk_lists_f32.restype = ctypes.c_int
        lib.merge_topk_lists_f32.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 2
        )
        lib.merge_topk_multi_f32.restype = ctypes.c_int
        lib.merge_topk_multi_f32.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        )
        _lib = lib
    return _lib


def _check(fn: str, pairs, k: int):
    """Each (d, i) pair: f32 / i32, (Q, c), contiguous, on one device."""
    q = pairs[0][0].shape[0]
    dev = pairs[0][0].device
    for d, i in pairs:
        for name, t, dtype in (("distances", d, torch.float32),
                               ("ids", i, torch.int32)):
            if t.device != dev:
                raise ValueError(f"{fn}: {name} on {t.device}, expected {dev}")
            if t.dtype != dtype or t.dim() != 2 or t.shape != d.shape \
                    or t.shape[0] != q:
                raise ValueError(f"{fn}: {name} must be {dtype} "
                                 f"({q}, {d.shape[1]}), got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{fn}: {name} must be contiguous")
    if q % Q_TILE:
        raise ValueError(f"{fn}: Q={q} is not a multiple of Q_TILE={Q_TILE} "
                         "(the ops wrappers pad)")
    if k < 1:
        raise ValueError(f"{fn}: k must be >= 1, got {k}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return q, dev


def _launch(wrapper, q: int, dev, k: int, a, b):
    """One kernel launch over the lists ``a`` and ``b`` (``b`` None: the R
    lists of k side by side in ``a``); counts it on ``wrapper.launches``,
    on ``wrapper.wide_launches`` where the kernel says it took a wide
    route, and on ``wrapper.wide_merge_launches`` where that was the wide
    merge (route 3)."""
    fn = wrapper.__name__
    lib = _kernel()
    ca = a[0].shape[1]
    cb = 0 if b is None else b[0].shape[1]
    if b is None and ca % k:
        raise ValueError(f"{fn}: the row's {ca} columns are not whole lists "
                         f"of k={k}; the kernel merges R = C / k ascending "
                         "lists")
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    outs = (out_d.data_ptr(), out_i.data_ptr())
    route = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if b is None:
            err = lib.merge_topk_multi_f32(a[0].data_ptr(), a[1].data_ptr(),
                                           ca // k, *outs, q, k, stream,
                                           ctypes.byref(route))
        else:
            err = lib.merge_topk_lists_f32(
                a[0].data_ptr(), a[1].data_ptr(), ca,
                b[0].data_ptr(), b[1].data_ptr(), cb, *outs, q, k, stream,
                ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with cudaError {err}")
    wrapper.launches += 1
    if route.value:
        wrapper.wide_launches += 1
    if route.value == 3:
        wrapper.wide_merge_launches += 1
    return out_d, out_i


def merge_topk_multi(d_cat, i_cat, *, k: int):
    """(Q, R*k) concatenated ascending lists -> (Q, k) merged, one launch.

    ``Q`` must be a multiple of ``Q_TILE`` (``ops.multi_merge_lists_op``
    pads and lays the per-shard lists out).  On the card each row must be
    R whole lists of k, each ascending under ``(d2, id)`` (the reference's
    precondition, ``repro/kernels/merge_topk.py:60``): ``C % k != 0``
    raises ``ValueError``.  On the CPU any row is taken.
    """
    q, dev = _check("merge_topk_multi", [(d_cat, i_cat)], k)
    if dev.type == "cpu":
        return merge_topk_multi_ref(d_cat, i_cat, k=k)
    return _launch(merge_topk_multi, q, dev, k, (d_cat, i_cat), None)


def merge_topk_lists(d_a, i_a, d_b, i_b, *, k: int):
    """(Q, ka) + (Q, kb) ascending lists -> (Q, k) merged ascending list.

    ``Q`` must be a multiple of ``Q_TILE`` (``ops.merge_topk_lists_op``
    pads and slices each input to k columns).  On the card each list must
    be ascending under ``(d2, id)``, +inf entries at its tail (the
    reference's precondition, ``repro/kernels/merge_topk.py:108``).
    """
    q, dev = _check("merge_topk_lists", [(d_a, i_a), (d_b, i_b)], k)
    if dev.type == "cpu":
        return merge_topk_lists_ref(d_a, i_a, d_b, i_b, k=k)
    return _launch(merge_topk_lists, q, dev, k, (d_a, i_a), (d_b, i_b))


merge_topk_multi.launches = 0
merge_topk_multi.wide_launches = 0
merge_topk_lists.launches = 0
merge_topk_lists.wide_launches = 0
merge_topk_lists.wide_merge_launches = 0
