"""K-NN_CPU: the sequential CPU kd-tree competitor (paper study S3).

The port's own copy of ``repro/core/cpu_ref.py``.  The paper uses FLANN's
single-core kd-tree with an optimized L2 functor and leaf size 32; this is
the same algorithmic class: a median-split kd-tree (widest-spread
dimension), array-based nodes, and a best-first branch-and-bound k-NN search
with a bounded max-heap.  Pure numpy and Python on one host core, by
definition: it is the sequential yardstick the card is compared with, not a
device path, so it takes no ``device`` and never touches the card.
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = ["KDTree"]


class KDTree:
    def __init__(self, points: np.ndarray, leaf_size: int = 32):
        self.points = np.asarray(points, np.float32)
        self.leaf_size = int(leaf_size)
        n = self.points.shape[0]
        self.idx = np.arange(n, dtype=np.int32)
        # node arrays (preallocated worst case ~ 2 * ceil(n/leaf) * 2)
        cap = max(4 * (n // leaf_size + 2), 16)
        self.split_dim = np.full(cap, -1, np.int32)
        self.split_val = np.zeros(cap, np.float32)
        self.left = np.full(cap, -1, np.int32)
        self.right = np.full(cap, -1, np.int32)
        self.lo = np.zeros(cap, np.int32)  # leaf: slice into idx
        self.hi = np.zeros(cap, np.int32)
        self.bb_min = np.zeros((cap, 2), np.float32)
        self.bb_max = np.zeros((cap, 2), np.float32)
        self._n_nodes = 0
        self.root = self._build(0, n)

    def _new_node(self) -> int:
        i = self._n_nodes
        self._n_nodes += 1
        return i

    def _build(self, lo: int, hi: int) -> int:
        node = self._new_node()
        pts = self.points[self.idx[lo:hi]]
        self.bb_min[node] = pts.min(axis=0)
        self.bb_max[node] = pts.max(axis=0)
        if hi - lo <= self.leaf_size:
            self.lo[node], self.hi[node] = lo, hi
            return node
        spread = self.bb_max[node] - self.bb_min[node]
        dim = int(np.argmax(spread))
        sub = self.idx[lo:hi]
        order = np.argsort(pts[:, dim], kind="stable")
        self.idx[lo:hi] = sub[order]
        mid = (lo + hi) // 2
        self.split_dim[node] = dim
        self.split_val[node] = self.points[self.idx[mid], dim]
        self.left[node] = self._build(lo, mid)
        self.right[node] = self._build(mid, hi)
        return node

    def _box_dist2(self, node: int, q: np.ndarray) -> float:
        d = np.maximum(np.maximum(self.bb_min[node] - q, q - self.bb_max[node]), 0.0)
        return float(d @ d)

    def query(self, q: np.ndarray, k: int, exclude: int = -2):
        """Best-first k-NN for a single query point. Returns (ids, dists) ascending."""
        q = np.asarray(q, np.float32)
        heap: list[tuple[float, int]] = []  # max-heap via negated dist
        pq: list[tuple[float, int]] = [(0.0, self.root)]
        kth = np.inf
        while pq:
            bd, node = heapq.heappop(pq)
            if bd >= kth and len(heap) >= k:
                break
            if self.split_dim[node] < 0:  # leaf
                ids = self.idx[self.lo[node] : self.hi[node]]
                pts = self.points[ids]
                d2 = ((pts - q) ** 2).sum(axis=1)
                for j in range(len(ids)):
                    oid = int(ids[j])
                    if oid == exclude:
                        continue
                    dj = float(d2[j])
                    if len(heap) < k:
                        heapq.heappush(heap, (-dj, oid))
                    elif dj < -heap[0][0]:
                        heapq.heapreplace(heap, (-dj, oid))
                if len(heap) >= k:
                    kth = -heap[0][0]
            else:
                l, r = int(self.left[node]), int(self.right[node])
                for ch in (l, r):
                    d = self._box_dist2(ch, q)
                    if d < kth or len(heap) < k:
                        heapq.heappush(pq, (d, ch))
        out = sorted((-nd, oid) for nd, oid in heap)
        ids = np.full(k, -1, np.int32)
        dist = np.full(k, np.inf, np.float32)
        for j, (d2, oid) in enumerate(out):
            ids[j] = oid
            dist[j] = np.sqrt(d2)
        return ids, dist

    def query_batch(self, qpos: np.ndarray, k: int, qid=None):
        nq = qpos.shape[0]
        ids = np.empty((nq, k), np.int32)
        dist = np.empty((nq, k), np.float32)
        for i in range(nq):
            ex = -2 if qid is None else int(qid[i])
            ids[i], dist[i] = self.query(qpos[i], k, exclude=ex)
        return ids, dist
