"""ExecutionPlan — how a tick's query batch is laid out, in PyTorch.

Counterpart of ``repro/core/plan.py``.  Four plans:

``single``
    Global Morton sort of the padded query batch, a chunked sweep, unsort.
    The reference maps its per-chunk program over the chunks with
    ``lax.map``; here all chunks run in lockstep in one sweep
    (``pipeline._knn_sorted_impl`` with ``n_chunks``), which keeps one host
    synchronisation per iteration instead of one per chunk and iteration.
    ``KnnStats.iterations`` is still the sum of each chunk's own trip count,
    and ``candidates`` the sum of each chunk's f32 candidate sum.
``sharded``
    The sorted batch split into R contiguous query shards (whole chunks),
    each swept over the whole index.
``object_sharded``
    The Morton-sorted object array split into R contiguous slices, a local
    quadtree over each, the whole batch swept over every slice, and the R
    partial lists reduced by a MERGE backend
    (``kernels.ops.tree_merge_lists``).
``hybrid``
    Both at once on a ``(query, object)`` grid: query shard ``i`` swept over
    object slice ``j``, lists reduced along the object axis.

The reference lays these shards onto a ``shard_map`` mesh of devices.  Here
a plan holds a mesh of :mod:`repro_torch.launch.mesh`: with no process
group a logical one, and every shard runs on the session's one device, one
after another (``mesh_shape`` counts logical shards); under a
``torch.distributed`` process group a ``DeviceMesh`` over the world's
ranks, and each rank runs its own grid cell, then gathers the partial lists
over the ``object`` group, the merged rows over the ``query`` group and the
counters over the world (:func:`_grid_run`).  Each shard reads exactly what
its device would (the same boundaries, the same ``capo``-row object window
with its clone rows), so per-shard counters and results equal the
reference's, and every rank ends a tick with the same bits.
Results never depend on the partition (the composition law of DESIGN.md
§12): every plan equals ``single`` bit for bit.  The reference's static
per-shard capacities exist for ``jit``; the port sweeps each query shard's
owned chunks directly, which is the reference's masked sweep without its
dead chunks (those give zero stats and are never gathered).

The drivers below the plans are the reference's: :func:`run_plan_device`
(padded tensors in, one plan's sweep), its two fixed-plan forms
:func:`knn_chunked_device` and :func:`knn_sharded_device`, and the host
wrapper :func:`knn_query_batch_chunked` (numpy in, numpy out).  Each takes
``device=``: ``None`` is the card, and the index must live on the device
named.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..kernels.ops import get_merge_backend, tree_merge_lists
from ..launch.mesh import (LogicalMesh, default_hybrid_shape,
                           make_object_mesh, make_query_mesh,
                           make_spatial_mesh, mesh_cell, world_size)
from ..runtime import fma, resolve_device, sqrt
from . import morton
from .balance import EqualPartitioner, Partitioner, resolve_partitioner
from .executor import resolve_executor
from .pipeline import (KnnStats, _knn_sorted_impl, _resolve_max_nav,
                       _sort_unsort)
from .quadtree import (
    QuadtreeIndex,
    _leaf_levels,
    build_index,
    local_pyramid_from_starts,
    starts_from_pyramid,
)

__all__ = [
    "ExecutionPlan",
    "PlanAux",
    "SinglePlan",
    "ShardedPlan",
    "ObjectShardedPlan",
    "HybridPlan",
    "register_plan",
    "resolve_plan",
    "plan_names",
    "default_hybrid_shape",
    "pad_capacity",
    "pad_queries",
    "object_shard_capacity",
    "run_plan_device",
    "knn_chunked_device",
    "knn_sharded_device",
    "knn_query_batch_chunked",
]

# EMA weight of the measured per-query candidate volume when the plan's
# partitioner defines none (EqualPartitioner)
_EMA_ALPHA_DEFAULT = 0.25


class PlanAux(NamedTuple):
    """Per-tick auxiliary outputs beside the result lists (see the reference).

    ``stats`` is the sum of the per-shard counters; ``shard_candidates`` /
    ``shard_iterations`` are (R_total,), query-major with the object index
    inner; ``qcost_next`` is the per-query cost EMA in the caller's row
    order; ``object_bounds`` the (R_o + 1,) Morton-row boundaries used.
    """

    stats: KnnStats
    shard_candidates: torch.Tensor
    shard_iterations: torch.Tensor
    qcost_next: torch.Tensor
    object_bounds: torch.Tensor


def pad_capacity(nq: int, multiple: int) -> int:
    """Padded row count for ``nq`` queries at the plan's granularity."""
    return max(1, -(-nq // multiple)) * multiple


def pad_queries(qpos, qid, multiple: int):
    """Host-side (numpy) pad of (Q,2)/(Q,) to :func:`pad_capacity` rows.

    Padding rows clone the last query with qid = -2, exactly as the
    reference pads, so padded batches and their stats are bit-identical.
    """
    nq = qpos.shape[0]
    padded = pad_capacity(nq, multiple)
    if padded == nq:
        return qpos, qid
    pad = padded - nq
    qpos = np.concatenate([qpos, np.tile(np.asarray(qpos[-1:]), (pad, 1))])
    qid = np.concatenate([np.asarray(qid), np.full((pad,), -2, np.int32)])
    return qpos, qid


def object_shard_capacity(n_objects: int, num_shards: int) -> int:
    """Rows per object shard under the equal partition: ``ceil(N / R)``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return -(-max(1, n_objects) // num_shards)


def _query_cost_estimate(index: QuadtreeIndex, qpos_s, window: int):
    """(Q,) f32 estimated candidate volume per sorted query: its own leaf's
    population plus one ``window``."""
    fine = morton.morton_encode_points(qpos_s, index.origin, index.side,
                                       index.l_max)
    lvl = index.leaf_level[fine]
    shift = 2 * (index.l_max - lvl)
    key = (fine >> shift) << shift
    span = torch.bitwise_left_shift(torch.ones_like(shift), shift)
    s0 = index.starts[key]
    e0 = index.starts[(key + span).clamp(0, index.n_fine)]
    return (e0 - s0).to(torch.float32) + float(window)


def _object_row_costs(index: QuadtreeIndex):
    """(N,) f32 per-object cost on the object axis: uniform, so the object
    axis is count-balanced (the reference's measured rationale)."""
    return torch.ones((index.n_objects,), dtype=torch.float32,
                      device=index.device)


def _ema_next(prev_rows, measured_rows, alpha: float):
    """Per-query cost EMA step; rows with no history adopt the measurement.

    The reference's ``(1 - a) * prev + a * measured`` compiles on the CPU to
    ``fma(1 - a, prev, a * measured)``; so it is spelled here.
    """
    a = torch.full_like(prev_rows, alpha)
    return torch.where(prev_rows > 0,
                       fma(1 - a, prev_rows, a * measured_rows), measured_rows)


def _pad_object_tail(index: QuadtreeIndex, extra: int):
    """Morton-sorted (pos, ids, codes) followed by ``extra`` rows that clone
    the last position and code, with id -1: a shard reads a ``capo``-row
    window from its boundary, and the last shard's window runs past N."""
    opos = torch.cat([index.pos, index.pos[-1:].expand(extra, 2)])
    oids = torch.cat([index.ids, torch.full((extra,), -1, dtype=torch.int32,
                                            device=index.device)])
    ocodes = torch.cat([index.codes, index.codes[-1:].expand(extra)])
    return opos, oids, ocodes


def _local_index(opos, oids, origin, side, *, l_max, th_quad):
    """A shard-local quadtree over one slice, built with the global geometry;
    ids remapped through ``oids`` back to global object ids."""
    local = build_index(opos, origin, side, l_max=l_max, th_quad=th_quad)
    return dataclasses.replace(local, ids=oids[local.ids])


def _local_index_derived(origin, side, opos_l, oids_l, codes_l, clone_code,
                         gstarts, start: int, own: int, capo: int, *, l_max,
                         th_quad):
    """The shard-local quadtree derived from the current global order: the
    slice is already sorted, and its pyramid is interval arithmetic over the
    global ``starts``.  Equal to :func:`_local_index` bit for bit whenever
    the global index is current for the sliced arrays."""
    pyramid = local_pyramid_from_starts(gstarts, start, own, clone_code, capo,
                                        l_max)
    return QuadtreeIndex(
        origin=origin,
        side=side,
        pos=opos_l,
        ids=oids_l,
        codes=codes_l,
        starts=starts_from_pyramid(pyramid, l_max),
        leaf_level=_leaf_levels(pyramid, l_max, th_quad),
        pyramid=pyramid,
        l_max=l_max,
        th_quad=th_quad,
    )


def _shard_local_index(index, opos, oids, ocodes, start: int, own: int,
                       capo: int, maintenance: str):
    """Object shard ``[start, start + own)``: its ``capo``-row window, with
    rows past ``own`` piled onto the last owned row with id -1, and its local
    quadtree (built under ``"rebuild"``, else derived)."""
    dev = index.device
    opos_raw = opos[start:start + capo]
    oids_raw = oids[start:start + capo]
    mask = torch.arange(capo, device=dev) < own
    last = min(max(own - 1, 0), capo - 1)
    opos_l = torch.where(mask[:, None], opos_raw, opos_raw[last][None, :])
    oids_l = torch.where(mask, oids_raw, -1)
    if maintenance == "rebuild":
        return _local_index(opos_l, oids_l, index.origin, index.side,
                            l_max=index.l_max, th_quad=index.th_quad)
    codes_raw = ocodes[start:start + capo]
    clone_code = codes_raw[last]
    codes_l = torch.where(mask, codes_raw, clone_code)
    return _local_index_derived(
        index.origin, index.side, opos_l, oids_l, codes_l, clone_code,
        index.starts, start, own, capo, l_max=index.l_max,
        th_quad=index.th_quad,
    )


def _zero_stats(device) -> KnnStats:
    return KnnStats(
        iterations=torch.zeros((), dtype=torch.int32, device=device),
        candidates=torch.zeros((), dtype=torch.float32, device=device),
        leaves_visited=torch.zeros((), dtype=torch.int32, device=device),
    )


def _chunked_sweep(index, qpos_s, qid_s, *, k, window, chunk, max_nav,
                   max_iters, executor):
    """The sorted-query sweep over whole chunks; per-chunk stats summed."""
    n_chunks = qpos_s.shape[0] // chunk
    idx, d2, st, cand_q = _knn_sorted_impl(
        index, qpos_s, qid_s, k, window, max_nav, max_iters, executor,
        n_chunks=n_chunks,
    )
    stats = KnnStats(
        iterations=st.iterations.sum(dtype=torch.int32),
        candidates=st.candidates.sum(),
        leaves_visited=st.leaves_visited.sum(dtype=torch.int32),
    )
    return idx, d2, stats, cand_q


def _stats_total(shard_stats: list[KnnStats]) -> KnnStats:
    """Per-shard stats -> global scalars: their sum.  The f32 candidate sum
    is a left fold in shard order, so ``candidates`` equals the same fold of
    ``shard_candidates`` wherever it is taken."""
    cand = shard_stats[0].candidates
    for st in shard_stats[1:]:
        cand = cand + st.candidates
    return KnnStats(
        iterations=torch.stack([s.iterations for s in shard_stats]).sum(
            dtype=torch.int32),
        candidates=cand,
        leaves_visited=torch.stack([s.leaves_visited for s in shard_stats])
        .sum(dtype=torch.int32),
    )


def _query_bounds(partitioner, index, qpos_s, order, qcost, qweight, *,
                  window, chunk, num_shards) -> list[int]:
    """Chunk-unit query boundaries from the cost seed: the EMA where a query
    has history, else the count-pyramid estimate, times ``qweight``."""
    n_chunks = qpos_s.shape[0] // chunk
    prev_s = qcost[order]
    cost_s = torch.where(prev_s > 0, prev_s,
                         _query_cost_estimate(index, qpos_s, window))
    if qweight is not None:
        cost_s = cost_s * qweight[order]
    bounds = partitioner.query_boundaries(
        cost_s.view(n_chunks, chunk).sum(dim=1), num_shards)
    tracing.count("host.syncs")
    return bounds.tolist()


def _check_rows(plan, nq: int, chunk: int):
    if nq % plan.pad_multiple(chunk):
        raise ValueError(f"{nq} query rows are not a multiple of "
                         f"{plan.pad_multiple(chunk)} (pad with pad_queries)")


class ExecutionPlan:
    """Interface: layout of one tick's query sweep."""

    name: ClassVar[str]

    @property
    def object_axis_size(self) -> int:
        """Shards on the object axis (1 = objects unsharded)."""
        return 1

    def pad_multiple(self, chunk: int) -> int:
        raise NotImplementedError

    def run(self, index: QuadtreeIndex, qpos, qid, qcost, *, k, window,
            chunk, max_nav, max_iters, executor, qweight=None,
            maintenance="rebuild"):
        """(index, padded Q) -> (idx, euclidean dist, PlanAux), caller order.

        ``qweight`` (Q,) scales each query's weight in the query boundaries
        only; ``maintenance`` is the tick's index refresh: the object-axis
        plans build their local trees under ``"rebuild"`` and derive them
        from the (current) global order otherwise.
        """
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SinglePlan(ExecutionPlan):
    """One shard: sort -> chunked sweep -> unsort."""

    name: ClassVar[str] = "single"

    def pad_multiple(self, chunk: int) -> int:
        return chunk

    def run(self, index, qpos, qid, qcost, *, k, window, chunk, max_nav,
            max_iters, executor, qweight=None, maintenance="rebuild"):
        del qweight, maintenance  # no split axis, no local trees
        _check_rows(self, qpos.shape[0], chunk)
        with tracing.span("plan.sort", device=True):
            order, inv = _sort_unsort(index, qpos)
            qpos_s, qid_s = qpos[order], qid[order]
        idx_s, d2_s, stats, cq_s = _chunked_sweep(
            index, qpos_s, qid_s, k=k, window=window, chunk=chunk,
            max_nav=max_nav, max_iters=max_iters, executor=executor,
        )
        with tracing.span("plan.unsort", device=True):
            qcost_next = _ema_next(qcost[order], cq_s,
                                   _EMA_ALPHA_DEFAULT)[inv]
            aux = PlanAux(
                stats=stats,
                shard_candidates=stats.candidates.reshape(1),
                shard_iterations=stats.iterations.reshape(1),
                qcost_next=qcost_next,
                object_bounds=torch.tensor([0, index.n_objects],
                                           dtype=torch.int32,
                                           device=qpos.device),
            )
            return idx_s[inv], sqrt(d2_s[inv]), aux

    def describe(self) -> str:
        return "plan=single shards=1 devices=1"


def _pack(idx, d2, cq):
    """(rows, k) ids and d2 and (rows,) candidate volumes as one (rows,
    2k + 1) int32 tensor, the floats by their bits: one collective a gather."""
    return torch.cat([idx, d2.view(torch.int32),
                      cq.view(torch.int32)[:, None]], 1)


def _unpack(packed, k: int):
    return (packed[..., :k].contiguous(),
            packed[..., k:2 * k].contiguous().view(torch.float32),
            packed[..., 2 * k].contiguous().view(torch.float32))


def _gather(t, group=None) -> list:
    """``all_gather`` of ``t`` over ``group`` (default: the world), in the
    group's rank order, which is the mesh dimension's order."""
    out = [torch.empty_like(t)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _gather_stats(st: KnnStats) -> list[KnnStats]:
    """Every rank's shard counters, in rank order (query-major), by their
    bits: the f32 candidates are gathered, never reduced in flight."""
    packed = torch.stack([st.iterations, st.candidates.view(torch.int32),
                          st.leaves_visited])
    return [KnnStats(iterations=p[0], candidates=p[1].view(torch.float32),
                     leaves_visited=p[2]) for p in _gather(packed)]


def _grid_run(index, qpos, qid, qcost, qweight, *, qd, od, mesh,
              partitioner, merge, maintenance, k, window, chunk, max_nav,
              max_iters, executor):
    """The (query, object) grid: on a logical mesh every cell in turn on one
    device, on a rank mesh this rank's own cell.

    Query shard ``i`` owns chunks ``[bq[i], bq[i+1])`` of the sorted batch.
    ``od = None`` sweeps the whole index (the ``sharded`` plan); otherwise
    object shard ``j`` owns the Morton rows ``[bo[j], bo[j+1])``, read
    through a ``capo``-row window into a local tree, and query shard ``i``'s
    ``od`` partial lists merge with ``merge``.  Per-shard counters are
    query-major, ``i * od + j``; ``cand_q`` sums over ``j`` in ``j`` order.

    Every rank computes the boundaries, the cost EMA and every decision from
    replicated inputs, and joins every collective whatever it owns: the
    object-axis gather (skipped by the whole ``object`` group when its query
    shard owns no chunk, which every rank knows), the query-axis gather
    (rows padded to the largest shard's, trimmed by ``bq``) and the counters'
    gather over the world.
    """
    dev = qpos.device
    nq = qpos.shape[0]
    order, inv = _sort_unsort(index, qpos)
    qpos_s, qid_s = qpos[order], qid[order]
    alpha = getattr(partitioner, "ema_alpha", _EMA_ALPHA_DEFAULT)
    if qd == 1:
        bq = [0, nq // chunk]
    else:
        bq = _query_bounds(partitioner, index, qpos_s, order, qcost, qweight,
                           window=window, chunk=chunk, num_shards=qd)
    object_axis = od is not None
    cell = mesh_cell(mesh)
    if cell is None:
        cells_i, cells_j = range(qd), range(od or 1)
    else:
        cells_i, cells_j = [cell[0]], [cell[1]]
    if not object_axis:
        bo_t = torch.tensor([0, index.n_objects], dtype=torch.int32,
                            device=dev)
        locals_ = {0: index}
    else:
        capo = partitioner.object_capacity(index.n_objects, od)
        bo_t = partitioner.object_boundaries(_object_row_costs(index), od)
        tracing.count("host.syncs")
        bo = bo_t.tolist()
        opos, oids, ocodes = _pad_object_tail(index, capo)
        locals_ = {
            j: _shard_local_index(index, opos, oids, ocodes, bo[j],
                                  bo[j + 1] - bo[j], capo, maintenance)
            for j in cells_j
        }
    shard_stats = []
    merged = {}  # query shard -> its rows' (idx, d2, cand_q), sorted order
    for i in cells_i:
        rows = slice(bq[i] * chunk, bq[i + 1] * chunk)
        if bq[i + 1] == bq[i]:  # owns no chunk: zero stats, nothing gathered
            shard_stats += [_zero_stats(dev)] * len(cells_j)
            continue
        parts = []
        for j in cells_j:
            idx_l, d2_l, st, cq_l = _chunked_sweep(
                locals_[j], qpos_s[rows], qid_s[rows], k=k, window=window,
                chunk=chunk, max_nav=max_nav, max_iters=max_iters,
                executor=executor,
            )
            parts.append((idx_l, d2_l, cq_l))
            shard_stats.append(st)
        if not object_axis:
            merged[i] = parts[0]
            continue
        if cell is not None:
            parts = [_unpack(p, k) for p in _gather(
                _pack(*parts[0]), mesh.get_group("object"))]
        d2_m, idx_m = tree_merge_lists(
            torch.stack([p[1] for p in parts]),
            torch.stack([p[0] for p in parts]), k=k, merge=merge)
        cq = parts[0][2]
        for p in parts[1:]:
            cq = cq + p[2]
        merged[i] = (idx_m, d2_m, cq)
    if cell is not None:
        shard_stats = _gather_stats(shard_stats[0])
        if "query" in mesh.mesh_dim_names:
            pad = max(b - a for a, b in zip(bq, bq[1:])) * chunk
            mine = merged.get(cell[0])
            packed = torch.zeros((pad, 2 * k + 1), dtype=torch.int32,
                                 device=dev)
            if mine is not None:
                packed[: mine[0].shape[0]] = _pack(*mine)
            blocks = _gather(packed, mesh.get_group("query"))
            merged = {i: _unpack(blocks[i][: (bq[i + 1] - bq[i]) * chunk], k)
                      for i in range(qd) if bq[i + 1] > bq[i]}
    idx_s, d2_s, cq_s = (torch.cat([merged[i][f] for i in sorted(merged)])
                         for f in range(3))
    aux = PlanAux(
        stats=_stats_total(shard_stats),
        shard_candidates=torch.stack([s.candidates for s in shard_stats]),
        shard_iterations=torch.stack([s.iterations for s in shard_stats]),
        qcost_next=_ema_next(qcost[order], cq_s, alpha)[inv],
        object_bounds=bo_t,
    )
    return idx_s[inv], sqrt(d2_s[inv]), aux


def _devices(mesh) -> str:
    """``devices=`` of a plan's description: 1 on a logical mesh, else the
    world and its backend."""
    if isinstance(mesh, LogicalMesh):
        return "devices=1"
    return f"devices={mesh.size()} backend={dist.get_backend()}"


@dataclasses.dataclass(frozen=True)
class ShardedPlan(ExecutionPlan):
    """Query-sharded sweep over the whole index: R query shards."""

    num_devices: int
    partitioner: Partitioner = EqualPartitioner()
    # laid at construction (launch.mesh): logical, or the world's ranks
    mesh: object = dataclasses.field(init=False, compare=False, repr=False)
    name: ClassVar[str] = "sharded"

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {self.num_devices}")
        object.__setattr__(self, "mesh", make_query_mesh(self.num_devices))

    def pad_multiple(self, chunk: int) -> int:
        # every query shard is a whole number of chunks
        return self.num_devices * chunk

    def run(self, index, qpos, qid, qcost, *, qweight=None,
            maintenance="rebuild", **kw):
        del maintenance  # the whole index is swept: no local trees
        _check_rows(self, qpos.shape[0], kw["chunk"])
        return _grid_run(index, qpos, qid, qcost, qweight,
                         qd=self.num_devices, od=None, mesh=self.mesh,
                         partitioner=self.partitioner, merge=None,
                         maintenance="rebuild", **kw)

    def describe(self) -> str:
        return (
            f"plan=sharded mesh=({self.num_devices},) axes=('query',) "
            f"shards={self.num_devices} {_devices(self.mesh)} "
            f"partitioner={self.partitioner.name}"
        )


@dataclasses.dataclass(frozen=True)
class ObjectShardedPlan(ExecutionPlan):
    """Morton-sliced objects, one local quadtree per slice, lists merged."""

    num_devices: int
    merge: str = "dense_merge"
    partitioner: Partitioner = EqualPartitioner()
    # laid at construction (launch.mesh): logical, or the world's ranks
    mesh: object = dataclasses.field(init=False, compare=False, repr=False)
    name: ClassVar[str] = "object_sharded"

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {self.num_devices}")
        get_merge_backend(self.merge)  # fail fast on unknown names
        object.__setattr__(self, "mesh", make_object_mesh(self.num_devices))

    @property
    def object_axis_size(self) -> int:
        return self.num_devices

    def pad_multiple(self, chunk: int) -> int:
        return chunk  # queries are not split

    def run(self, index, qpos, qid, qcost, *, qweight=None,
            maintenance="rebuild", **kw):
        del qweight  # queries are not split: no boundary to seed
        _check_rows(self, qpos.shape[0], kw["chunk"])
        return _grid_run(index, qpos, qid, qcost, None, qd=1,
                         od=self.num_devices, mesh=self.mesh,
                         partitioner=self.partitioner, merge=self.merge,
                         maintenance=maintenance, **kw)

    def describe(self) -> str:
        return (
            f"plan=object_sharded mesh=({self.num_devices},) "
            f"axes=('object',) shards={self.num_devices} "
            f"{_devices(self.mesh)} "
            f"merge={self.merge} partitioner={self.partitioner.name}"
        )


@dataclasses.dataclass(frozen=True)
class HybridPlan(ExecutionPlan):
    """``(query, object)`` grid: both decompositions composed."""

    query_devices: int
    object_devices: int
    merge: str = "dense_merge"
    partitioner: Partitioner = EqualPartitioner()
    # laid at construction (launch.mesh): logical, or the world's ranks
    mesh: object = dataclasses.field(init=False, compare=False, repr=False)
    name: ClassVar[str] = "hybrid"

    def __post_init__(self):
        if self.query_devices < 1 or self.object_devices < 1:
            raise ValueError(
                "mesh_shape axes must be >= 1, got "
                f"({self.query_devices}, {self.object_devices})"
            )
        get_merge_backend(self.merge)
        object.__setattr__(self, "mesh", make_spatial_mesh(
            self.query_devices, self.object_devices))

    @property
    def object_axis_size(self) -> int:
        return self.object_devices

    def pad_multiple(self, chunk: int) -> int:
        return self.query_devices * chunk

    def run(self, index, qpos, qid, qcost, *, qweight=None,
            maintenance="rebuild", **kw):
        _check_rows(self, qpos.shape[0], kw["chunk"])
        return _grid_run(index, qpos, qid, qcost, qweight,
                         qd=self.query_devices, od=self.object_devices,
                         mesh=self.mesh, partitioner=self.partitioner,
                         merge=self.merge, maintenance=maintenance, **kw)

    def describe(self) -> str:
        return (
            f"plan=hybrid mesh=({self.query_devices}, {self.object_devices}) "
            f"axes=('query', 'object') "
            f"shards={self.query_devices * self.object_devices} "
            f"{_devices(self.mesh)} "
            f"merge={self.merge} partitioner={self.partitioner.name}"
        )


# name -> factory(num_devices | None, partitioner, merge | None)
_PLANS: dict = {}


def register_plan(name: str):
    """Decorator: register an ExecutionPlan factory under ``name``."""

    def deco(factory):
        _PLANS[name] = factory
        return factory

    return deco


def plan_names() -> tuple[str, ...]:
    """Names accepted by ``resolve_plan`` / ``ServiceSpec.plan``."""
    return tuple(sorted(_PLANS))


@register_plan("single")
def _make_single(num_devices=None, partitioner=None, merge=None):
    return SinglePlan()


def _as_1d(name: str, num_devices) -> int:
    """``mesh_shape`` of a 1-D plan; ``None`` is every device: the world's
    ranks under a process group, else the session's one device."""
    if num_devices is None:
        return world_size() or 1
    if isinstance(num_devices, (tuple, list)):
        raise ValueError(
            f"plan {name!r} lays a 1-D mesh; mesh_shape must be an int, "
            f"got {tuple(num_devices)!r} (use plan='hybrid' for 2-D shapes)"
        )
    return int(num_devices)


@register_plan("sharded")
def _make_sharded(num_devices=None, partitioner=None, merge=None):
    return ShardedPlan(num_devices=_as_1d("sharded", num_devices),
                       partitioner=resolve_partitioner(partitioner))


@register_plan("object_sharded")
def _make_object_sharded(num_devices=None, partitioner=None, merge=None):
    return ObjectShardedPlan(
        num_devices=_as_1d("object_sharded", num_devices),
        partitioner=resolve_partitioner(partitioner),
        **({} if merge is None else {"merge": str(merge)}),
    )


@register_plan("hybrid")
def _make_hybrid(num_devices=None, partitioner=None, merge=None):
    if isinstance(num_devices, (tuple, list)):
        if len(num_devices) != 2:
            raise ValueError(
                f"hybrid mesh_shape must be (query, object), got {num_devices!r}"
            )
        q, o = (int(x) for x in num_devices)
    else:
        q, o = default_hybrid_shape(num_devices)
    return HybridPlan(
        query_devices=q, object_devices=o,
        partitioner=resolve_partitioner(partitioner),
        **({} if merge is None else {"merge": str(merge)}),
    )


def resolve_plan(plan, *, num_devices=None, partitioner=None,
                 merge=None) -> ExecutionPlan:
    """Name | ExecutionPlan | None -> ExecutionPlan (default: single).

    ``num_devices`` is ``mesh_shape``: an int of shards for the 1-D plans,
    a ``(query, object)`` pair for ``hybrid``; ``None`` is every device (one
    without a process group, the world size under one).  Under a process
    group the mesh's size must equal the world size.
    ``partitioner`` and ``merge`` are registry names (defaults ``equal`` and
    ``dense_merge``), ignored when ``plan`` is already an instance.
    """
    if plan is None:
        return SinglePlan()
    if isinstance(plan, ExecutionPlan):
        return plan
    try:
        factory = _PLANS[str(plan)]
    except KeyError:
        raise ValueError(
            f"unknown execution plan {plan!r}; registered: {plan_names()}"
        ) from None
    return factory(num_devices, partitioner, merge)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def _index_device(index: QuadtreeIndex, device) -> torch.device:
    """The device a driver runs on: ``device`` resolved (``None`` is the
    card, which raises without one), and it must be where the index lives."""
    dev = resolve_device(device)
    have = index.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the index lives on {have}, not on {dev}; build it "
                         f"there or pass device={str(have)!r}")
    return have


def run_plan_device(index: QuadtreeIndex, qpos: torch.Tensor,
                    qid: torch.Tensor, qcost: torch.Tensor | None = None,
                    qweight: torch.Tensor | None = None, *, k: int,
                    window: int, chunk: int, max_nav: int, max_iters: int,
                    executor, plan: ExecutionPlan,
                    maintenance: str = "rebuild", device=None):
    """Memory-bounded batch k-NN, laid out by ``plan``, on the index's device.

    ``Q`` must already be a whole number of ``plan.pad_multiple(chunk)``
    rows (callers pad on the host with :func:`pad_queries`).  ``qcost`` is
    the (Q,) per-query cost EMA (None: no history), ``qweight`` the optional
    (Q,) weights of the query boundaries' seed, ``maintenance`` the tick's
    refresh mode forwarded to the plan (see :meth:`ExecutionPlan.run`).

    Returns (nn_idx (Q, k) i32, nn_dist (Q, k) f32 euclidean, aux
    :class:`PlanAux`) in the caller's query order, padding rows included.
    """
    dev = _index_device(index, device)
    nq = qpos.shape[0]
    assert nq % plan.pad_multiple(chunk) == 0, (nq, chunk, plan)
    if qcost is None:
        qcost = torch.zeros((nq,), dtype=torch.float32, device=dev)
    return plan.run(
        index,
        qpos.to(device=dev, dtype=torch.float32),
        qid.to(device=dev, dtype=torch.int32),
        qcost.to(device=dev, dtype=torch.float32),
        k=k, window=window, chunk=chunk, max_nav=max_nav,
        max_iters=max_iters, executor=executor,
        qweight=None if qweight is None else qweight.to(
            device=dev, dtype=torch.float32),
        maintenance=maintenance,
    )


def knn_chunked_device(index, qpos, qid, *, k, window, chunk, max_nav,
                       max_iters, executor, device=None):
    """The single plan's sweep, with the reference's 3-tuple return
    ``(nn_idx, nn_dist, stats)``."""
    ii, dd, aux = run_plan_device(
        index, qpos, qid, k=k, window=window, chunk=chunk, max_nav=max_nav,
        max_iters=max_iters, executor=executor, plan=SinglePlan(),
        device=device,
    )
    return ii, dd, aux.stats


def knn_sharded_device(index, qpos, qid, *, k, window, chunk, max_nav,
                       max_iters, executor, num_devices, device=None):
    """The sharded plan's sweep over ``num_devices`` logical query shards."""
    ii, dd, aux = run_plan_device(
        index, qpos, qid, k=k, window=window, chunk=chunk, max_nav=max_nav,
        max_iters=max_iters, executor=executor,
        plan=ShardedPlan(num_devices=num_devices), device=device,
    )
    return ii, dd, aux.stats


def knn_query_batch_chunked(index: QuadtreeIndex, qpos, qid=None, *,
                            k: int = 32, window: int = 128, chunk: int = 8192,
                            max_nav: int | None = None,
                            max_iters: int = 100_000, backend=None,
                            precision=None, plan=None,
                            num_devices: int | None = None, partitioner=None,
                            merge=None, maintenance: str = "rebuild",
                            with_aux: bool = False, device=None):
    """Host-friendly wrapper over :func:`run_plan_device` (numpy in and out).

    ``plan``/``num_devices``/``partitioner``/``merge`` select the execution
    plan by name (default ``single`` / ``equal`` / ``dense_merge``);
    ``backend``/``precision`` the executor (default ``dense_topk`` /
    ``fp32``).  ``qid=None`` marks every query external (-2).  The batch is
    padded here and the padding stripped, on the host.  ``maintenance``
    forwards the local-tree path to the object-axis plans (``"incremental"``
    derives them from the index's order, which a built index is current
    for).  ``with_aux=True`` appends the host :class:`PlanAux` (per-shard
    counters as numpy arrays, the cost EMA, object boundaries; ``stats`` as
    Python numbers): the straggler-gap probe.
    """
    dev = _index_device(index, device)
    nq = qpos.shape[0]
    if qid is None:
        qid = np.full((nq,), -2, np.int32)
    plan = resolve_plan(plan, num_devices=num_devices, partitioner=partitioner,
                        merge=merge)
    qpos_p, qid_p = pad_queries(np.asarray(qpos), np.asarray(qid),
                                plan.pad_multiple(chunk))
    ii, dd, aux = run_plan_device(
        index,
        torch.tensor(np.asarray(qpos_p, np.float32), device=dev),
        torch.tensor(np.asarray(qid_p, np.int32), device=dev),
        k=k, window=window, chunk=chunk,
        max_nav=_resolve_max_nav(index, max_nav), max_iters=max_iters,
        executor=resolve_executor(backend, precision), plan=plan,
        maintenance=maintenance, device=dev,
    )
    stats = KnnStats(
        iterations=int(aux.stats.iterations),
        candidates=float(aux.stats.candidates),
        leaves_visited=int(aux.stats.leaves_visited),
    )
    out = (ii[:nq].cpu().numpy(), dd[:nq].cpu().numpy(), stats)
    if with_aux:
        out += (PlanAux(
            stats=stats,
            shard_candidates=aux.shard_candidates.cpu().numpy(),
            shard_iterations=aux.shard_iterations.cpu().numpy(),
            qcost_next=aux.qcost_next[:nq].cpu().numpy(),
            object_bounds=aux.object_bounds.cpu().numpy(),
        ),)
    return out
