"""Padding wrapper around the fused kernel + the SCAN backend registry.

Counterpart of ``repro/kernels/ops.py`` for the backends the main path uses.
Every backend implements ``merge(qpos, cpos, cids, valid, best_d, best_i, k,
precision="fp32")``: the k smallest of the union of the current list and the
window, ascending ``(d2, id)``, lowest id on ties, ``(inf, -1)`` padded, so
the backends are interchangeable bit for bit.

- ``dense_topk`` / ``brute``: plain PyTorch, a two-key lexicographic sort
  (stable sort by id, then stable sort by d2) of the concatenated row;
- ``fused_bucket``: the hand-written CUDA kernel
  (:func:`repro_torch.kernels.fused_scan.fused_scan_merge`).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..runtime import fma
from . import fused_scan as _fs

__all__ = [
    "fused_scan_merge_op",
    "register_scan_backend",
    "get_scan_backend",
    "scan_backend_names",
]


def _pad_to(x, n, fill):
    if x.shape[0] == n:
        return x.contiguous()
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _check_precision(precision: str):
    if precision != "fp32":
        raise NotImplementedError(
            f"precision={precision!r}: the mixed-precision prefilter is not "
            "ported yet (ROADMAP item A9)")


def fused_scan_merge_op(qpos, cpos, cids, valid, best_d, best_i, *, k: int,
                        precision: str = "fp32"):
    """Pad Q to ``Q_TILE``, split the coordinate planes, dispatch, slice back.

    qpos (Q,2) x per-query windows cpos (Q,W,2) / cids / valid (Q,W) x
    current lists best_d/best_i (Q,k) -> merged (Q,k) lists.
    """
    _check_precision(precision)
    q = qpos.shape[0]
    qp = -(-q // _fs.Q_TILE) * _fs.Q_TILE
    qx = _pad_to(qpos[:, 0].to(torch.float32), qp, 0)
    qy = _pad_to(qpos[:, 1].to(torch.float32), qp, 0)
    cx = _pad_to(cpos[:, :, 0].to(torch.float32), qp, 0)
    cy = _pad_to(cpos[:, :, 1].to(torch.float32), qp, 0)
    ci = _pad_to(cids.to(torch.int32), qp, -1)
    v = _pad_to(valid, qp, False)
    bd = _pad_to(best_d.to(torch.float32), qp, float("inf"))
    bi = _pad_to(best_i.to(torch.int32), qp, -1)
    out_d, out_i = _fs.fused_scan_merge(qx, qy, cx, cy, ci, v, bd, bi, k=k)
    return out_d[:q], out_i[:q]


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

    Two stable sorts (by id, then by d2) give the order of the reference's
    two-key ``lax.sort``.  The reference's compiled distance is
    ``fma(dx, dx, dy * dy)``.
    """
    _check_precision(precision)
    dx = cpos[:, :, 0] - qpos[:, None, 0]
    dy = cpos[:, :, 1] - qpos[:, None, 1]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=qpos.device)
    d2 = torch.where(valid, fma(dx, dx, dy * dy), inf)
    all_d = torch.cat([best_d, d2], dim=1)
    all_i = torch.cat([best_i, cids.to(torch.int32)], dim=1)
    by_id = torch.sort(all_i, dim=1, stable=True).indices
    all_d = torch.gather(all_d, 1, by_id)
    all_i = torch.gather(all_i, 1, by_id)
    sd, by_d = torch.sort(all_d, dim=1, stable=True)
    out_d = sd[:, :k]
    out_i = torch.gather(all_i, 1, by_d[:, :k])
    return out_d, torch.where(torch.isinf(out_d), -1, out_i).to(torch.int32)


register_scan_backend("dense_topk")(_lex_sort_merge)
register_scan_backend("brute")(_lex_sort_merge)


@register_scan_backend("fused_bucket")
def _fused_bucket_merge(qpos, cpos, cids, valid, best_d, best_i, k: int,
                        precision: str = "fp32"):
    """The hand-written CUDA kernel (its plain version for CPU tensors)."""
    return fused_scan_merge_op(qpos, cpos, cids, valid, best_d, best_i, k=k,
                               precision=precision)
