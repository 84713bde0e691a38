"""Iterated batch processing of k-NN queries over ticks, in PyTorch.

Counterpart of ``repro/core/ticks.py``: the engine configuration and its
eager validation, the per-tick result record, the device-side delta scatter
and its routing by owning object shard, the per-shard churn accounting of
incremental maintenance, and the per-tick step (index refresh, the plan's
sweep, the drift check).  :class:`TickEngine` is the reference's deprecation
shim over a session: a blocking snapshot-per-tick loop through
:meth:`repro_torch.api.KnnSession.process_tick`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..kernels.ops import merge_backend_names
from .balance import partitioner_names
from .executor import QueryExecutor, available_backends, available_precisions
from .plan import ExecutionPlan, object_shard_capacity, plan_names
from .quadtree import QuadtreeIndex, reindex_objects, reindex_objects_delta

__all__ = [
    "TickEngine",
    "TickResult",
    "EngineConfig",
    "MAINTENANCE_MODES",
    "validate_engine_params",
    "scatter_positions",
    "object_shard_of",
    "route_delta",
    "delta_shard_counts",
    "shard_churn_over_budget",
]

MAINTENANCE_MODES = ("rebuild", "incremental")


def validate_engine_params(*, k, window, chunk, backend, plan, mesh_shape=None,
                           partitioner=None, precision=None, merge=None,
                           maintenance=None, churn_budget=None):
    """Eager validation shared by ``EngineConfig`` and ``ServiceSpec``.

    The same checks and messages as the reference: unknown names raise
    ``ValueError`` with the registry listing, and so does geometry the
    chunked sweep cannot serve.
    """
    if isinstance(backend, str) and backend not in available_backends():
        raise ValueError(
            f"unknown backend {backend!r}; registered SCAN backends: "
            f"{available_backends()}"
        )
    if isinstance(plan, str) and plan not in plan_names():
        raise ValueError(
            f"unknown execution plan {plan!r}; registered plans: "
            f"{plan_names()}"
        )
    if isinstance(partitioner, str) and partitioner not in partitioner_names():
        raise ValueError(
            f"unknown partitioner {partitioner!r}; registered partitioners: "
            f"{partitioner_names()}"
        )
    if precision is not None and precision not in available_precisions():
        raise ValueError(
            f"unknown precision {precision!r}; one of {available_precisions()}"
        )
    if isinstance(merge, str) and merge not in merge_backend_names():
        raise ValueError(
            f"unknown merge backend {merge!r}; registered MERGE backends: "
            f"{merge_backend_names()}"
        )
    if maintenance is not None and maintenance not in MAINTENANCE_MODES:
        raise ValueError(
            f"unknown maintenance mode {maintenance!r}; one of "
            f"{MAINTENANCE_MODES}"
        )
    if churn_budget is not None and not (0.0 < churn_budget <= 1.0):
        raise ValueError(f"churn_budget must be in (0, 1], got {churn_budget!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if chunk < 1 or chunk % window != 0:
        raise ValueError(
            f"chunk ({chunk}) must be a positive multiple of window ({window})"
        )
    if k > chunk:
        raise ValueError(f"k ({k}) must be <= chunk ({chunk})")
    if mesh_shape is not None:
        if isinstance(mesh_shape, (tuple, list)):
            if len(mesh_shape) != 2 or any(
                not isinstance(d, int) or d < 1 for d in mesh_shape
            ):
                raise ValueError(
                    "mesh_shape tuples must be a (query, object) pair of "
                    f"positive ints, got {mesh_shape!r}"
                )
            if isinstance(plan, str) and plan != "hybrid":
                raise ValueError(
                    f"plan {plan!r} lays a 1-D mesh; mesh_shape must be an "
                    f"int, got {tuple(mesh_shape)!r}"
                )
        elif mesh_shape < 1:
            raise ValueError(f"mesh_shape must be >= 1, got {mesh_shape}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    k: int = 32
    th_quad: int = 192
    l_max: int = 8
    window: int = 256
    chunk: int = 8192
    rebuild_factor: float = 2.0  # rebuild partition when work grows by this factor
    region_pad: float = 1e-3
    backend: str = "dense_topk"
    plan: str = "single"
    mesh_shape: int | tuple[int, int] | None = None
    partitioner: str = "equal"
    precision: str = "fp32"
    merge: str = "dense_merge"
    maintenance: str = "rebuild"
    churn_budget: float = 0.25
    max_iters: int = 100_000

    def __post_init__(self):
        validate_engine_params(
            k=self.k, window=self.window, chunk=self.chunk,
            backend=self.backend, plan=self.plan, mesh_shape=self.mesh_shape,
            partitioner=self.partitioner, precision=self.precision,
            merge=self.merge, maintenance=self.maintenance,
            churn_budget=self.churn_budget,
        )


@dataclasses.dataclass
class TickResult:
    tick: int
    nn_idx: np.ndarray | None  # (Q, k); tensors under result(materialize=False)
    nn_dist: np.ndarray | None  # (Q, k) euclidean
    rebuilt: bool
    wall_s: float  # submit -> results materialized, excluding compile_s
    candidates: float
    iterations: int
    compile_s: float = 0.0  # kernel build seconds inside this tick's submit
    qids: np.ndarray | None = None  # (Q,) registry qids, row-aligned with nn_*
    shard_candidates: np.ndarray | None = None  # (R_total,) f32
    shard_iterations: np.ndarray | None = None  # (R_total,) i32
    collect_s: float = 0.0  # device -> host transfer time of this result
    # the sink's TickAggregates (repro_torch.api.sink) under collect="stats";
    # None under "full" and "none"
    aggregates: object | None = None
    maintenance: str = "rebuild"  # how this tick's step refreshed the index
    # the tick's spans and counters (repro_torch.tracing); None tracing off
    trace: tracing.TickTrace | None = None

    @property
    def kth_dist(self):
        """(Q,) Euclidean k-th distance per query row, or None.

        ``nn_dist[:, -1]`` where the lists are present (host array or device
        tensor, as the result holds them); else the sink's
        ``aggregates.kth_dist`` sliced to the live rows.  It is the radius of
        each row's result ball, which the serving layer's spatial cache
        invalidation stores per entry.
        """
        if self.nn_dist is not None:
            return self.nn_dist[:, -1]
        agg = self.aggregates
        if agg is not None and getattr(agg, "kth_dist", None) is not None:
            kd = agg.kth_dist
            if self.qids is not None:
                kd = kd[: self.qids.shape[0]]
            return kd
        return None


def _tick_step(index, positions, qpos, qid, qcost, work_at_build,
               rebuild_factor, qweight=None, *, k: int, window: int,
               chunk: int, max_nav: int, max_iters: int,
               executor: QueryExecutor, plan: ExecutionPlan,
               maintenance: str = "rebuild", delta_ids=None,
               delta_old_pos=None):
    """(index, P_tau, Q_tau) -> (index', nn_idx, nn_dist, aux, should_rebuild).

    ``maintenance``: ``"rebuild"`` re-sorts all positions into the existing
    partition (``reindex_objects``); ``"incremental"`` splices only the
    ``delta_ids`` rows (sentinel-N padded, unique; ``delta_old_pos`` their
    positions as of the last refresh) into the old order
    (``reindex_objects_delta``), the same bits; ``"skip"`` keeps the index,
    whose order is already current for this very buffer.  The mode and
    ``qweight`` (the optional (Q,) boundary-seed weights) go on to
    ``plan.run``.  ``work_at_build`` and ``rebuild_factor`` are f32 tensors;
    the drift rule is the reference's
    ``candidates > rebuild_factor * work_at_build`` in f32.
    """
    if (delta_ids is None) != (maintenance != "incremental"):
        raise ValueError("delta_ids (and delta_old_pos) go with "
                         "maintenance='incremental' only")
    if maintenance == "rebuild":
        with tracing.span("refresh", device=True):
            index = reindex_objects(index, positions)
    elif maintenance == "incremental":
        with tracing.span("refresh", device=True):
            index = reindex_objects_delta(index, positions, delta_ids,
                                          delta_old_pos)
    elif maintenance != "skip":
        raise ValueError(f"unknown step maintenance mode {maintenance!r}")
    nn_idx, nn_dist, aux = plan.run(
        index, qpos, qid, qcost, k=k, window=window, chunk=chunk,
        max_nav=max_nav, max_iters=max_iters, executor=executor,
        qweight=qweight, maintenance=maintenance,
    )
    should_rebuild = aux.stats.candidates > rebuild_factor * work_at_build
    return index, nn_idx, nn_dist, aux, should_rebuild


def object_shard_of(index: QuadtreeIndex, ids: torch.Tensor, num_shards: int,
                    bounds: torch.Tensor | None = None) -> torch.Tensor:
    """Owning object shard of each object id under the live index, (m,) i32.

    An object's owner follows its Morton rank in the index: rank divided by
    ``ceil(N / num_shards)`` under the equal partition, or the interval of
    ``bounds`` (a tick's ``PlanAux.object_bounds``) that holds the rank.
    ``ids`` must lie in ``[0, N)``.
    """
    n = index.n_objects
    rank = torch.empty((n,), dtype=torch.int32, device=index.device)
    rank[index.ids.long()] = torch.arange(n, dtype=torch.int32,
                                          device=index.device)
    r = rank[ids.long()]
    if bounds is None:
        return r // object_shard_capacity(n, num_shards)
    return (torch.searchsorted(bounds, r, right=True) - 1).to(torch.int32)


def route_delta(index: QuadtreeIndex, ids: torch.Tensor, new_pos: torch.Tensor,
                num_shards: int, bounds: torch.Tensor | None = None):
    """A (sentinel-padded) delta batch grouped by owning shard, on the device.

    Rows stable-sorted by :func:`object_shard_of`; sentinel rows (id >= N)
    sort last.  A pure reorder of unique ids, so the scattered buffer is the
    same bits.
    """
    order = torch.argsort(_shard_or_sentinel(index, ids, num_shards, bounds),
                          stable=True)
    return ids[order], new_pos[order]


def _shard_or_sentinel(index: QuadtreeIndex, ids: torch.Tensor,
                       num_shards: int, bounds: torch.Tensor | None):
    """Each row's owning object shard; ``num_shards`` for a sentinel row
    (id >= N)."""
    n = index.n_objects
    owner = object_shard_of(index, ids.clamp(0, max(n - 1, 0)), num_shards,
                            bounds)
    return torch.where(ids < n, owner, num_shards)


def delta_shard_counts(index: QuadtreeIndex, ids: torch.Tensor,
                       num_shards: int,
                       bounds: torch.Tensor | None = None) -> torch.Tensor:
    """Pending delta rows per owning object shard, (num_shards,) i32.

    Each valid id of a (sentinel-padded) pending batch counts against the
    shard that owns it under the live index, the rule :func:`route_delta`
    sorts by (its source shard); sentinel rows (id >= N) fall into a virtual
    shard ``num_shards`` that is sliced off.
    """
    shard = _shard_or_sentinel(index, ids, num_shards, bounds)
    return torch.bincount(shard.long(), minlength=num_shards + 1)[
        :num_shards].to(torch.int32)


def shard_churn_over_budget(index: QuadtreeIndex, ids: torch.Tensor,
                            num_shards: int, budget: float,
                            bounds: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Does any object shard's pending churn exceed ``budget`` x its owned
    rows?  A () bool tensor.

    Owned counts come from ``bounds`` (the boundaries the last tick used) or
    the equal-capacity rule clipped to N.  The comparison is strict, in f32
    with the f32 product ``budget * owned``: churn exactly at the budget
    stays incremental, as the session's global ``<=`` rule.
    """
    n = index.n_objects
    counts = delta_shard_counts(index, ids, num_shards, bounds)
    if bounds is None:
        cap = object_shard_capacity(n, num_shards)
        edges = (torch.arange(num_shards + 1, dtype=torch.int32,
                              device=index.device) * cap).clamp(max=n)
    else:
        edges = bounds.to(torch.int32)
    owned = (edges[1:] - edges[:-1]).to(torch.float32)
    limit = torch.tensor(budget, dtype=torch.float32,
                         device=index.device) * owned
    return (counts.to(torch.float32) > limit).any()


def scatter_positions(positions: torch.Tensor, ids: torch.Tensor,
                      new_pos: torch.Tensor) -> torch.Tensor:
    """Delta object ingest: write ``new_pos`` rows at ``ids``, on the device.

    Rows whose id is out of range (the sentinel ``N`` that pads a batch) are
    dropped.  The port updates the buffer in place: every tick reads the
    buffer through work already queued on the same stream (the index refresh
    copies it into Morton order), so a later scatter cannot change a tick
    already submitted, and the in-place write saves an (N, 2) copy per batch.
    ``ids`` must be unique.
    """
    keep = (ids >= 0) & (ids < positions.shape[0])
    positions[ids[keep]] = new_pos[keep].to(positions.dtype)
    return positions


class TickEngine:
    """Deprecation shim: the snapshot-per-tick API over a session.

    ``process_tick`` stages a full position snapshot and a full query batch
    and blocks for the results, through :class:`repro_torch.api.KnnSession`
    (snapshot ingest, bulk ``set_queries``, ``submit().result()``), as the
    reference's shim does.  ``device=None`` runs on the card (and raises
    without one).  New code should build a ``KnnSession`` from a
    ``ServiceSpec`` and use persistent query handles and delta updates.
    """

    def __init__(self, cfg: EngineConfig, origin=(0.0, 0.0),
                 side: float = 22_500.0, device=None):
        warnings.warn(
            "TickEngine is a deprecation shim over "
            "repro_torch.api.KnnSession; migrate to the session API "
            "(ServiceSpec + KnnSession)",
            DeprecationWarning,
            stacklevel=2,
        )
        from ..api import KnnSession, ServiceSpec  # lazy: api sits above core

        self.cfg = cfg
        self.origin = np.asarray(origin, np.float32)
        self.side = float(side)
        self.session = KnnSession(
            ServiceSpec.from_engine(
                cfg, origin=(float(self.origin[0]), float(self.origin[1])),
                side=self.side,
            ),
            device=device,
        )
        self.tick = 0
        self.history: list[TickResult] = []

    # the reference's attribute surface (benchmarks and examples read these)
    @property
    def executor(self) -> QueryExecutor:
        return self.session.executor

    @property
    def plan(self) -> ExecutionPlan:
        return self.session.plan

    @property
    def index(self):
        return self.session.index

    def process_tick(self, positions: np.ndarray, qpos: np.ndarray,
                     qid: np.ndarray | None) -> TickResult:
        """One iteration of the repeated spatial join: (P, Q) -> R."""
        res = self.session.process_tick(positions, qpos, qid)
        self.tick += 1
        self.history.append(res)
        return res

    def run(self, workload, ticks: int, query_rate: float = 1.0,
            on_tick: Callable[[TickResult], None] | None = None):
        """Drive a MovingObjectWorkload for ``ticks`` ticks (paper: 30)."""
        out = []
        for _ in range(ticks):
            qpos, qid = workload.query_batch(query_rate)
            res = self.process_tick(workload.positions(), qpos, qid)
            out.append(res)
            if on_tick:
                on_tick(res)
            workload.advance()
        return out
