"""PyTorch port of the repeated k-NN system, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Entry points run on the card unless the caller passes
``device="cpu"``.  So far the port covers ``KnnSession`` ticks on every
execution plan (the mesh plans' shards run one after another on the one
card, or one grid cell per ``torch.distributed`` rank under a process
group, ``launch.mesh``) and every collect mode, through the hand-written CUDA kernels
``kernels/csrc/fused_scan.cu`` (backend ``fused_bucket``) and
``kernels/csrc/merge_topk.cu`` (merges ``fused_multi`` and ``fused_merge``),
the multi-tenant server (``repro_torch.serve``), the ``knn`` entry point
(``repro_torch.launch.serve``), the reference's evaluation entry points
(``TickEngine``, ``core.knn_query_batch_chunked``, the five workload
families of ``make_workload`` and the sequential ``core.KDTree``) and the
examples under ``examples_torch/``.
"""
from .api import KnnSession, QueryHandle, ServiceSpec, TickHandle
from .core.pipeline import KnnStats, knn_query_batch
from .core.quadtree import QuadtreeIndex, build_index
from .core.ticks import EngineConfig, TickEngine
from .data import make_workload
from .runtime import resolve_device

__all__ = [
    "EngineConfig",
    "KnnSession",
    "KnnStats",
    "QueryHandle",
    "QuadtreeIndex",
    "ServiceSpec",
    "TickEngine",
    "TickHandle",
    "build_index",
    "knn_query_batch",
    "make_workload",
    "resolve_device",
]
