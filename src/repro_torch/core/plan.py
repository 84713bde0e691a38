"""ExecutionPlan — how a tick's query batch is laid onto the device.

Counterpart of ``repro/core/plan.py`` for the ``single`` plan: global Morton
sort of the padded query batch, a chunked sweep, unsort.  The reference maps
its per-chunk program over the chunks with ``lax.map``; here all chunks run in
lockstep in one sweep (``pipeline._knn_sorted_impl`` with ``n_chunks``), which
keeps one host synchronisation per iteration instead of one per chunk and
iteration.  ``KnnStats.iterations`` is still the sum of each chunk's own trip
count, and ``candidates`` the sum of each chunk's f32 candidate sum.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from ..runtime import sqrt
from .pipeline import KnnStats, _knn_sorted_impl, _sort_unsort
from .quadtree import QuadtreeIndex

__all__ = [
    "ExecutionPlan",
    "PlanAux",
    "SinglePlan",
    "PLAN_NAMES",
    "resolve_plan",
    "pad_capacity",
    "pad_queries",
]

# every plan name the reference registers; only "single" is ported so far
PLAN_NAMES = ("hybrid", "object_sharded", "sharded", "single")

_EMA_ALPHA_DEFAULT = 0.25


class PlanAux(NamedTuple):
    """Per-tick auxiliary outputs beside the result lists (see the reference)."""

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


def _ema_next(prev_rows, measured_rows, alpha: float):
    """Per-query cost EMA step; rows with no history adopt the measurement."""
    a = torch.tensor(alpha, dtype=torch.float32, device=prev_rows.device)
    return torch.where(prev_rows > 0,
                       (1 - a) * prev_rows + a * measured_rows, measured_rows)


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


class ExecutionPlan:
    """Interface: device layout of one tick's query sweep."""

    name: ClassVar[str]

    def pad_multiple(self, chunk: int) -> int:
        raise NotImplementedError

    def run(self, index: QuadtreeIndex, qpos, qid, qcost, *, k, window,
            chunk, max_nav, max_iters, executor):
        """(index, padded Q) -> (idx, euclidean dist, PlanAux), caller order."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SinglePlan(ExecutionPlan):
    """One device: sort -> chunked sweep -> unsort."""

    name: ClassVar[str] = "single"

    def pad_multiple(self, chunk: int) -> int:
        return chunk

    def run(self, index, qpos, qid, qcost, *, k, window, chunk, max_nav,
            max_iters, executor):
        nq = qpos.shape[0]
        if nq % chunk:
            raise ValueError(f"{nq} query rows are not a multiple of "
                             f"chunk={chunk} (pad with pad_queries)")
        order, inv = _sort_unsort(index, qpos)
        idx_s, d2_s, stats, cq_s = _chunked_sweep(
            index, qpos[order], qid[order], k=k, window=window, chunk=chunk,
            max_nav=max_nav, max_iters=max_iters, executor=executor,
        )
        qcost_next = _ema_next(qcost[order], cq_s, _EMA_ALPHA_DEFAULT)[inv]
        aux = PlanAux(
            stats=stats,
            shard_candidates=stats.candidates.reshape(1),
            shard_iterations=stats.iterations.reshape(1),
            qcost_next=qcost_next,
            object_bounds=torch.tensor([0, index.n_objects], dtype=torch.int32,
                                       device=qpos.device),
        )
        return idx_s[inv], sqrt(d2_s[inv]), aux


def resolve_plan(plan, **_ignored) -> ExecutionPlan:
    """Name | ExecutionPlan | None -> ExecutionPlan (default: single).

    The mesh plans exist in the reference but are not ported yet: naming
    one raises ``NotImplementedError`` (ROADMAP item A10).
    """
    if plan is None:
        return SinglePlan()
    if isinstance(plan, ExecutionPlan):
        return plan
    name = str(plan)
    if name == "single":
        return SinglePlan()
    if name in PLAN_NAMES:
        raise NotImplementedError(
            f"plan {name!r} is not ported yet (ROADMAP item A10); the port "
            "runs plan='single'")
    raise ValueError(f"unknown execution plan {plan!r}; registered: "
                     f"{PLAN_NAMES}")
