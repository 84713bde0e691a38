"""Padding wrappers around the kernels + the SCAN and MERGE registries.

Counterpart of ``repro/kernels/ops.py``.  The kernel API's wrappers pad like
the reference's: :func:`pairwise_dist_op` (Q to 8, C to 128),
:func:`bucket_kselect_op` and :func:`topk_select_op` (Q to 8).

Every SCAN backend implements
``merge(qpos, cpos, cids, valid, best_d, best_i, k, precision="fp32")``: the
k smallest of the union of the current list and the window, ascending
``(d2, id)``, lowest id on ties, ``(inf, -1)`` padded, so the backends are
interchangeable bit for bit.  Under ``precision="mixed"`` each first narrows
``valid`` by the bf16 prefilter
(:func:`~repro_torch.kernels.refine.mixed_prune_keep`), which never drops an
entry that can reach the merged list, so the lists are fp32's.

- ``dense_topk`` / ``brute``: plain PyTorch, a two-key lexicographic sort
  (stable sort by id, then stable sort by d2) of the concatenated row;
- ``fused_bucket``: the hand-written CUDA kernel
  (:func:`repro_torch.kernels.fused_scan.fused_scan_merge`).

Every MERGE backend implements ``merge(d_a, i_a, d_b, i_b, k)``: the k
smallest of the union of two ascending ``(inf, -1)`` padded lists, with the
same tie rule, so the object-axis plans' reduce composes bit for bit:

- ``dense_merge``: plain PyTorch, the two stable sorts of the concatenated
  row (:func:`topk_select_ref`);
- ``fused_merge``: the hand-written CUDA kernel
  (:func:`repro_torch.kernels.merge_topk.merge_topk_lists`);
- ``fused_multi``: the same kernel's R-way form
  (:func:`repro_torch.kernels.merge_topk.merge_topk_multi`), which
  :func:`tree_merge_lists` calls once for the whole reduce.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..runtime import fma
from . import bucket_kselect as _bk
from . import fused_scan as _fs
from . import merge_topk as _mt
from . import pairwise_dist as _pd
from . import topk_select as _tk
from .refine import mixed_prune_keep

__all__ = [
    "pairwise_dist_op",
    "bucket_kselect_op",
    "topk_select_op",
    "fused_scan_merge_op",
    "merge_topk_lists_op",
    "multi_merge_lists_op",
    "topk_select_ref",
    "tree_merge_lists",
    "register_scan_backend",
    "get_scan_backend",
    "scan_backend_names",
    "register_merge_backend",
    "get_merge_backend",
    "merge_backend_names",
]


def _pad_to(x, n, fill):
    if x.shape[0] == n:
        return x.contiguous()
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pairwise_dist_op(qpos, ppos, valid=None):
    """(Q,2) x (C,2) [+ (C,) mask] -> (Q, C) masked squared distances."""
    q, c = qpos.shape[0], ppos.shape[0]
    qp, cp = _round_up(q, _pd.Q_TILE), _round_up(c, _pd.C_TILE)
    if valid is None:
        valid = torch.ones((c,), dtype=torch.bool, device=ppos.device)
    qx = _pad_to(qpos[:, 0].to(torch.float32), qp, 0)
    qy = _pad_to(qpos[:, 1].to(torch.float32), qp, 0)
    px = _pad_to(ppos[:, 0].to(torch.float32), cp, 0)
    py = _pad_to(ppos[:, 1].to(torch.float32), cp, 0)
    v = _pad_to(valid, cp, False)
    return _pd.pairwise_dist(qx, qy, px, py, v)[:q, :c]


def bucket_kselect_op(qpos, ppos, valid=None, *, k: int, num_bins: int = 32,
                      iters: int = 4):
    """(Q,2) queries x (C,2) shared candidates -> (Q,) k-selection radius."""
    q, c = qpos.shape[0], ppos.shape[0]
    qp = _round_up(q, _bk.Q_TILE)
    if valid is None:
        valid = torch.ones((c,), dtype=torch.bool, device=ppos.device)
    qx = _pad_to(qpos[:, 0].to(torch.float32), qp, 0)
    qy = _pad_to(qpos[:, 1].to(torch.float32), qp, 0)
    out = _bk.bucket_kselect(
        qx, qy, ppos[:, 0].to(torch.float32).contiguous(),
        ppos[:, 1].to(torch.float32).contiguous(), valid.contiguous(), k=k,
        num_bins=num_bins, iters=iters)
    return out[:q]


def topk_select_op(d2, ids, *, k: int):
    """(Q, C) distances + ids -> ((Q, k), (Q, k)) ascending top-k smallest."""
    qp = _round_up(d2.shape[0], _tk.Q_TILE)
    d2p = _pad_to(d2.to(torch.float32), qp, float("inf"))
    idsp = _pad_to(ids.to(torch.int32), qp, -1)
    out_d, out_i = _tk.topk_select(d2p, idsp, k=k)
    return out_d[:d2.shape[0]], out_i[:d2.shape[0]]


def fused_scan_merge_op(qpos, cpos, cids, valid, best_d, best_i, *, k: int,
                        precision: str = "fp32"):
    """Pad Q to ``Q_TILE``, split the coordinate planes, dispatch, slice back.

    qpos (Q,2) x per-query windows cpos (Q,W,2) / cids / valid (Q,W) x
    current lists best_d/best_i (Q,k) -> merged (Q,k) lists.
    """
    q = qpos.shape[0]
    qp = _round_up(q, _fs.Q_TILE)
    qx = _pad_to(qpos[:, 0].to(torch.float32), qp, 0)
    qy = _pad_to(qpos[:, 1].to(torch.float32), qp, 0)
    cx = _pad_to(cpos[:, :, 0].to(torch.float32), qp, 0)
    cy = _pad_to(cpos[:, :, 1].to(torch.float32), qp, 0)
    ci = _pad_to(cids.to(torch.int32), qp, -1)
    v = _pad_to(valid, qp, False)
    bd = _pad_to(best_d.to(torch.float32), qp, float("inf"))
    bi = _pad_to(best_i.to(torch.int32), qp, -1)
    out_d, out_i = _fs.fused_scan_merge(qx, qy, cx, cy, ci, v, bd, bi, k=k,
                                        precision=precision)
    return out_d[:q], out_i[:q]


def merge_topk_lists_op(d_a, i_a, d_b, i_b, *, k: int):
    """Two ascending lists per row, (Q, ka) and (Q, kb) -> (Q, k) merged.

    Only the first k columns of an ascending list can reach the output, so
    each input is sliced to k columns before dispatch; Q pads to ``Q_TILE``.
    """
    q = d_a.shape[0]
    qp = _round_up(max(q, 1), _mt.Q_TILE)
    da = _pad_to(d_a[:, :k].to(torch.float32), qp, float("inf"))
    ia = _pad_to(i_a[:, :k].to(torch.int32), qp, -1)
    db = _pad_to(d_b[:, :k].to(torch.float32), qp, float("inf"))
    ib = _pad_to(i_b[:, :k].to(torch.int32), qp, -1)
    out_d, out_i = _mt.merge_topk_lists(da, ia, db, ib, k=k)
    return out_d[:q], out_i[:q]


def multi_merge_lists_op(d_all, i_all, *, k: int):
    """(R, Q, >=k) per-shard lists -> (Q, k), one kernel launch.

    Each query's R lists are laid side by side into one (Q, R*k) row.
    """
    r, q = d_all.shape[0], d_all.shape[1]
    d_cat = d_all[:, :, :k].transpose(0, 1).reshape(q, r * k)
    i_cat = i_all[:, :, :k].transpose(0, 1).reshape(q, r * k)
    qp = _round_up(max(q, 1), _mt.Q_TILE)
    d_cat = _pad_to(d_cat.to(torch.float32), qp, float("inf"))
    i_cat = _pad_to(i_cat.to(torch.int32), qp, -1)
    out_d, out_i = _mt.merge_topk_multi(d_cat, i_cat, k=k)
    return out_d[:q], out_i[:q]


def topk_select_ref(d2, ids, k: int):
    """Per-row k smallest ``(d2, id)`` pairs, ascending, ``(inf, -1)`` padded.

    Two stable sorts (by id, then by d2) give the order of the reference's
    two-key ``lax.sort``.
    """
    by_id = torch.sort(ids, dim=1, stable=True).indices
    d2 = torch.gather(d2, 1, by_id)
    ids = torch.gather(ids, 1, by_id)
    sd, by_d = torch.sort(d2, dim=1, stable=True)
    out_d = sd[:, :k]
    out_i = torch.gather(ids, 1, by_d[:, :k])
    return out_d, torch.where(torch.isinf(out_d), -1, out_i).to(torch.int32)


ScanMergeFn = Callable[..., tuple]

_SCAN_BACKENDS: dict[str, ScanMergeFn] = {}


def register_scan_backend(name: str):
    """Decorator: register a SCAN merge strategy under ``name``."""

    def deco(fn: ScanMergeFn) -> ScanMergeFn:
        _SCAN_BACKENDS[name] = fn
        return fn

    return deco


def get_scan_backend(name: str) -> ScanMergeFn:
    try:
        return _SCAN_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown scan backend {name!r}; registered: {scan_backend_names()}"
        ) from None


def scan_backend_names() -> tuple[str, ...]:
    return tuple(sorted(_SCAN_BACKENDS))


def _lex_sort_merge(qpos, cpos, cids, valid, best_d, best_i, k: int,
                    precision: str = "fp32"):
    """Concatenated row -> lexicographic ``(d2, id)`` sort -> first k.

    The reference's compiled distance is ``fma(dx, dx, dy * dy)``.
    """
    dx = cpos[:, :, 0] - qpos[:, None, 0]
    dy = cpos[:, :, 1] - qpos[:, None, 1]
    if precision == "mixed":
        valid = valid & mixed_prune_keep(dx, dy, best_d[:, k - 1])
    inf = torch.full((), float("inf"), dtype=torch.float32, device=qpos.device)
    d2 = torch.where(valid, fma(dx, dx, dy * dy), inf)
    all_d = torch.cat([best_d, d2], dim=1)
    all_i = torch.cat([best_i, cids.to(torch.int32)], dim=1)
    return topk_select_ref(all_d, all_i, k)


register_scan_backend("dense_topk")(_lex_sort_merge)
register_scan_backend("brute")(_lex_sort_merge)


@register_scan_backend("fused_bucket")
def _fused_bucket_merge(qpos, cpos, cids, valid, best_d, best_i, k: int,
                        precision: str = "fp32"):
    """The hand-written CUDA kernel (its plain version for CPU tensors)."""
    return fused_scan_merge_op(qpos, cpos, cids, valid, best_d, best_i, k=k,
                               precision=precision)


MergeListsFn = Callable[..., tuple]

_MERGE_BACKENDS: dict[str, MergeListsFn] = {}


def register_merge_backend(name: str):
    """Decorator: register a result-list merge strategy under ``name``."""

    def deco(fn: MergeListsFn) -> MergeListsFn:
        _MERGE_BACKENDS[name] = fn
        return fn

    return deco


def get_merge_backend(name: str) -> MergeListsFn:
    try:
        return _MERGE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown merge backend {name!r}; registered: "
            f"{merge_backend_names()}"
        ) from None


def merge_backend_names() -> tuple[str, ...]:
    return tuple(sorted(_MERGE_BACKENDS))


@register_merge_backend("dense_merge")
def _dense_merge_lists(d_a, i_a, d_b, i_b, k: int):
    """Plain PyTorch: two stable sorts of the concatenated row."""
    return topk_select_ref(torch.cat([d_a, d_b], dim=1),
                           torch.cat([i_a, i_b], dim=1), k)


@register_merge_backend("fused_merge")
def _fused_merge_lists(d_a, i_a, d_b, i_b, k: int):
    """The hand-written CUDA kernel (its plain version for CPU tensors)."""
    return merge_topk_lists_op(d_a, i_a, d_b, i_b, k=k)


@register_merge_backend("fused_multi")
def _fused_multi_lists(d_a, i_a, d_b, i_b, k: int):
    """Binary form of the R-way kernel, so the name also meets the binary
    MERGE contract: each side (inf, -1)-padded to k columns, then stacked."""

    def _block(d, i):
        d = d[:, :k].to(torch.float32)
        i = i[:, :k].to(torch.int32)
        pad = k - d.shape[1]
        if pad > 0:
            q = d.shape[0]
            d = torch.cat([d, torch.full((q, pad), float("inf"),
                                         device=d.device)], dim=1)
            i = torch.cat([i, torch.full((q, pad), -1, dtype=torch.int32,
                                         device=i.device)], dim=1)
        return d, i

    da, ia = _block(d_a, i_a)
    db, ib = _block(d_b, i_b)
    return multi_merge_lists_op(torch.stack([da, db]), torch.stack([ia, ib]),
                                k=k)


def tree_merge_lists(d_all, i_all, *, k: int, merge="dense_merge"):
    """(R, Q, >=k) per-shard lists -> (Q, k) merged list.

    Pairwise rounds of the selected MERGE backend; an odd tail passes a
    round unmerged.  The selection is associative and commutative on
    id-disjoint lists, so any tree gives the same bits.  ``fused_multi``
    skips the tree: one :func:`multi_merge_lists_op` launch over all R.
    """
    if d_all.shape[0] < 1:
        raise ValueError("tree_merge_lists needs at least one shard list")
    if isinstance(merge, str) and merge == "fused_multi":
        return multi_merge_lists_op(d_all, i_all, k=k)
    fn = get_merge_backend(merge) if isinstance(merge, str) else merge
    lists = [(d_all[r], i_all[r]) for r in range(d_all.shape[0])]
    while len(lists) > 1:
        nxt = [fn(*lists[a], *lists[a + 1], k)
               for a in range(0, len(lists) - 1, 2)]
        if len(lists) % 2:
            nxt.append(lists[-1])
        lists = nxt
    d, i = lists[0]
    return d[:, :k], i[:, :k]
