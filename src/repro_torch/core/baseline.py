"""K-NN_BASELINE: the brute-force k-NN of Garcia et al. (paper ref [4], S2).

Counterpart of ``repro/core/baseline.py``: the full (Q x N) distance matrix,
then the k smallest of each row.  Plain PyTorch, as the reference's is jnp;
it doubles as the test oracle of the indexed pipeline.  Its bits follow the
reference's compiled CPU program:

- ``jnp.sum((q - p)**2, -1)`` is evaluated as ``fma(dy, dy, dx*dx)`` (the
  opposite operand order to the kernels' ``fma(dx, dx, dy*dy)``);
- ``lax.top_k`` on ``-d2`` puts equal distances in index order, which is a
  stable ascending sort (``torch.topk`` leaves the order of ties open);
- the distance is the correctly rounded square root (``runtime.sqrt``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..runtime import fma, resolve_device, sqrt

__all__ = ["knn_bruteforce", "knn_bruteforce_chunked"]


def knn_bruteforce(points, qpos, qid, k: int):
    """(N,2) objects, (Q,2) queries, (Q,) issuer ids -> (Q,k) ids, dists.

    Tensors on one device; the query's own object (``qid``) is excluded, and
    rows with fewer than k objects are padded with ``(-1, inf)``.
    """
    points = points.to(torch.float32)
    qpos = qpos.to(torch.float32)
    dx = qpos[:, None, 0] - points[None, :, 0]
    sq = dx * dx
    del dx
    dy = qpos[:, None, 1] - points[None, :, 1]
    d2 = fma(dy, dy, sq)
    del dy, sq
    ids = torch.arange(points.shape[0], dtype=torch.int32,
                       device=points.device)
    d2.masked_fill_(ids[None, :] == qid.to(torch.int32)[:, None],
                    float("inf"))
    kk = min(k, points.shape[0])
    sd, idx = torch.sort(d2, dim=1, stable=True)
    del d2
    dist = sqrt(sd[:, :kk])
    idx = torch.where(torch.isinf(dist), -1, idx[:, :kk].to(torch.int32))
    if kk < k:  # fewer objects than requested neighbours: pad (-1, inf)
        q = qpos.shape[0]
        idx = torch.cat([idx, torch.full((q, k - kk), -1, dtype=torch.int32,
                                         device=idx.device)], 1)
        dist = torch.cat([dist, torch.full((q, k - kk), float("inf"),
                                           device=dist.device)], 1)
    return idx, dist


def knn_bruteforce_chunked(points, qpos, qid=None, *, k: int = 32,
                           chunk: int = 2048, device=None):
    """Memory-bounded brute force (the S2 baseline at scale), numpy in and out.

    Queries go through :func:`knn_bruteforce` ``chunk`` rows at a time on
    ``device`` (the card unless ``device="cpu"``).  The reference pads the
    last chunk to ``chunk`` rows (copies of its last query, ``qid`` -2) so
    that one compiled shape serves every chunk; rows are independent and
    PyTorch compiles nothing, so here the last chunk runs at its own size,
    with the same results.
    """
    dev = resolve_device(device)
    nq = qpos.shape[0]
    if qid is None:
        qid = np.full((nq,), -2, np.int32)
    pts = torch.as_tensor(np.asarray(points), device=dev)
    out_i, out_d = [], []
    for lo in range(0, nq, chunk):
        hi = min(lo + chunk, nq)
        qp = torch.as_tensor(np.asarray(qpos[lo:hi]), device=dev)
        qi = torch.as_tensor(np.asarray(qid[lo:hi], dtype=np.int32),
                             device=dev)
        ii, dd = knn_bruteforce(pts, qp, qi, k)
        out_i.append(ii.cpu().numpy())
        out_d.append(dd.cpu().numpy())
    if not out_i:
        return (np.zeros((0, k), np.int32), np.zeros((0, k), np.float32))
    return np.concatenate(out_i), np.concatenate(out_d)
