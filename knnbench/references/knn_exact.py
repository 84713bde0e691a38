"""The plain reference of the k-NN configurations: exact k nearest neighbours
by brute force, in plain PyTorch.

The answer the configurations state, for a query at ``q`` issued by object
``qid``: the ``k`` objects nearest to ``q`` by squared distance, the issuer
excluded, ties to the lowest id, in ascending ``(distance, id)`` order; the
squared distance is ``fma(dx, dx, dy * dy)`` in float32 with ``dx``, ``dy``
each rounded once, and the distance is its correctly rounded square root.
So an answer has one right value, bit for bit.

Each row of the ``(B, N)`` distance block becomes a unique int64 key (the
float's bits above the id), so one ``topk`` gives the exact order with its
ties.  ``precision="bf16"`` computes the same in bfloat16, the next precision
below the configurations' float32: the control that the check has to fail.

Imports nothing of the program.
"""
from __future__ import annotations

import torch

# distance elements per block: 2**26 is about 1.5 GB of temporaries
BLOCK_ELEMS = 1 << 26


def squared_distance(px, py, qx, qy, precision: str = "fp32"):
    """(B, N) squared distances of queries ``(qx, qy)`` to points ``(px, py)``."""
    if precision == "bf16":
        bf = torch.bfloat16
        dx = px.to(bf)[None, :] - qx.to(bf)[:, None]
        dy = py.to(bf)[None, :] - qy.to(bf)[:, None]
        return (dx * dx + dy * dy).to(torch.float32)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    dx = px[None, :] - qx[:, None]
    dy = py[None, :] - qy[:, None]
    return torch.addcmul(dy * dy, dx, dx)  # fma(dx, dx, dy * dy)


def knn(points, qpos, qid, k: int, precision: str = "fp32"):
    """(N, 2) points, (Q, 2) queries, (Q,) issuer ids -> (Q, k) ids, dists.

    Tensors on one device; float32 positions, int ids.  Returns int32 ids
    and float32 Euclidean distances.
    """
    n = points.shape[0]
    if n < k + 1:
        raise ValueError(f"{n} points cannot answer k = {k} excluding self")
    px, py = points[:, 0].float(), points[:, 1].float()
    ids = torch.arange(n, device=points.device, dtype=torch.int64)
    block = max(1, BLOCK_ELEMS // n)
    out_i, out_d = [], []
    for lo in range(0, qpos.shape[0], block):
        q = qpos[lo:lo + block].float()
        d2 = squared_distance(px, py, q[:, 0], q[:, 1], precision)
        own = ids[None, :] == qid[lo:lo + block].to(torch.int64)[:, None]
        d2.masked_fill_(own, float("inf"))
        key = (d2.view(torch.int32).to(torch.int64) << 32) | ids[None, :]
        del d2, own
        key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        out_i.append((key & 0xFFFFFFFF).to(torch.int32))
        d2k = (key >> 32).to(torch.int32).view(torch.float32)
        out_d.append(torch.sqrt(d2k.double()).float())
    return torch.cat(out_i), torch.cat(out_d)
