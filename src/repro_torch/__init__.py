"""PyTorch port of the repeated k-NN system, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Entry points run on the card unless the caller passes
``device="cpu"``.  So far the port covers the main path: one tick of a
``KnnSession`` on the ``single`` plan, through the hand-written CUDA kernel
``kernels/csrc/fused_scan.cu`` (backend ``fused_bucket``).
"""
from .api import KnnSession, QueryHandle, ServiceSpec, TickHandle
from .core.pipeline import KnnStats, knn_query_batch
from .core.quadtree import QuadtreeIndex, build_index
from .runtime import resolve_device

__all__ = [
    "KnnSession",
    "KnnStats",
    "QueryHandle",
    "QuadtreeIndex",
    "ServiceSpec",
    "TickHandle",
    "build_index",
    "knn_query_batch",
    "resolve_device",
]
