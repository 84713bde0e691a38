"""The paper's contribution: iterated batched k-NN over moving objects, in
PyTorch.  The reference's ``repro.core`` export list wherever the port has
the name (the registries' listings are ``plan.plan_names`` and
``balance.partitioner_names``)."""
from .balance import (
    CostBalancedPartitioner,
    EqualPartitioner,
    Partitioner,
    partitioner_names,
    resolve_partitioner,
    straggler_gap,
)
from .baseline import knn_bruteforce, knn_bruteforce_chunked
from .cpu_ref import KDTree
from .executor import (
    QueryExecutor,
    available_backends,
    resolve_executor,
)
from .kselect import find_kdist
from .pipeline import KnnStats, knn_query_batch
from .plan import (
    ExecutionPlan,
    HybridPlan,
    ObjectShardedPlan,
    PlanAux,
    ShardedPlan,
    SinglePlan,
    knn_chunked_device,
    knn_query_batch_chunked,
    knn_sharded_device,
    object_shard_capacity,
    pad_capacity,
    pad_queries,
    resolve_plan,
    run_plan_device,
)
from .quadtree import (
    QuadtreeIndex,
    build_index,
    leaf_of_points,
    local_pyramid_from_starts,
    pyramid_delta,
    rebuild_zmap,
    reindex_objects,
    reindex_objects_delta,
    starts_from_pyramid,
)
from .ticks import (
    MAINTENANCE_MODES,
    EngineConfig,
    TickEngine,
    TickResult,
    delta_shard_counts,
    object_shard_of,
    scatter_positions,
    shard_churn_over_budget,
    validate_engine_params,
)

__all__ = [
    "knn_bruteforce",
    "knn_bruteforce_chunked",
    "KDTree",
    "QueryExecutor",
    "Partitioner",
    "EqualPartitioner",
    "CostBalancedPartitioner",
    "PlanAux",
    "available_backends",
    "partitioner_names",
    "resolve_partitioner",
    "straggler_gap",
    "resolve_executor",
    "resolve_plan",
    "find_kdist",
    "KnnStats",
    "knn_chunked_device",
    "knn_query_batch",
    "knn_query_batch_chunked",
    "knn_sharded_device",
    "object_shard_capacity",
    "object_shard_of",
    "pad_capacity",
    "pad_queries",
    "run_plan_device",
    "scatter_positions",
    "validate_engine_params",
    "ExecutionPlan",
    "SinglePlan",
    "ShardedPlan",
    "ObjectShardedPlan",
    "HybridPlan",
    "QuadtreeIndex",
    "build_index",
    "leaf_of_points",
    "local_pyramid_from_starts",
    "pyramid_delta",
    "rebuild_zmap",
    "delta_shard_counts",
    "shard_churn_over_budget",
    "reindex_objects",
    "reindex_objects_delta",
    "starts_from_pyramid",
    "MAINTENANCE_MODES",
    "EngineConfig",
    "TickEngine",
    "TickResult",
]
