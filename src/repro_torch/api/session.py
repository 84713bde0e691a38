"""KnnSession — the session-oriented serving facade, in PyTorch.

Counterpart of ``repro/api/session.py`` for every plan, both maintenance
modes and every collect mode: persistent query groups in a padded registry
(or one bulk query set, ``set_queries``),
delta object updates scattered on the device (grouped by owning object shard
under the object-axis plans), per-query boundary-seed weights, and ticks
submitted through :func:`repro_torch.core.ticks._tick_step`.  Under
``maintenance="incremental"`` the session keeps the set of objects moved
since the last index refresh, with each one's position as of that refresh,
and splices them into the index while they stay within the churn budget
(``churn_budget`` x N, and on an object-axis plan the same fraction of every
shard's owned rows); otherwise a tick re-sorts every row.  Drift-rebuild
bookkeeping is finalized per tick, in submit order, at the earlier of that
tick's ``result()`` and the next ``submit()``, exactly as the reference does,
so the sequence of rebuild decisions matches the reference tick for tick.
Under ``collect="stats"`` each tick's padded lists go to a
:class:`~repro_torch.api.sink.StatsSink` queued right behind the tick, whose
memory resets with the cost EMA whenever the registry's row set changes.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from .. import tracing
from ..core.executor import resolve_executor
from ..core.pipeline import default_max_nav
from ..core.plan import pad_capacity, pad_queries, resolve_plan
from ..core.quadtree import build_index, rebuild_zmap, reindex_objects_delta
from ..core.ticks import (
    _tick_step,
    object_shard_of,
    route_delta,
    scatter_positions,
    shard_churn_over_budget,
)
from ..kernels.build import build_seconds
from ..runtime import resolve_device
from .handles import QueryHandle, TickHandle
from .sink import StatsSink
from .spec import ServiceSpec

__all__ = ["KnnSession"]


class _QueryRegistry:
    """Host mirror + cached padded device staging of the live query set.

    Rows stay contiguous (drops compact); padding rows clone the last query
    with qid = -2 (:func:`repro_torch.core.plan.pad_queries`).  ``owner``
    maps each row to the handle that registered it (-1 for bulk
    ``set_queries`` rows).
    """

    def __init__(self, multiple: int, device: torch.device):
        self.multiple = multiple
        self.device = device
        self.qpos = np.zeros((0, 2), np.float32)
        self.qid = np.zeros((0,), np.int32)
        self.owner = np.zeros((0,), np.int64)
        self._next_hid = 0
        self._live: set[int] = set()
        self._dirty = True
        self._staged = None
        # the per-query cost EMA is row-aligned: it resets when rows change
        self.rows_changed = True

    @property
    def nq(self) -> int:
        return int(self.qpos.shape[0])

    def _coerce(self, qpos, qid):
        qpos = np.asarray(qpos, np.float32).reshape(-1, 2)
        m = qpos.shape[0]
        if qid is None:
            qid = np.full((m,), -2, np.int32)
        else:
            qid = np.asarray(qid, np.int32).reshape(-1)
            if qid.shape[0] != m:
                raise ValueError(f"qid has {qid.shape[0]} rows but qpos has {m}")
        return qpos, qid

    def register(self, qpos, qid=None) -> QueryHandle:
        qpos, qid = self._coerce(qpos, qid)
        m = qpos.shape[0]
        if m == 0:
            raise ValueError("cannot register an empty query group")
        hid = self._next_hid
        self._next_hid += 1
        self.qpos = np.concatenate([self.qpos, qpos])
        self.qid = np.concatenate([self.qid, qid])
        self.owner = np.concatenate([self.owner, np.full((m,), hid, np.int64)])
        self._live.add(hid)
        self._dirty = True
        self.rows_changed = True
        return QueryHandle(hid=hid, count=m)

    def rows(self, handle: QueryHandle) -> np.ndarray:
        if handle.hid not in self._live:
            raise KeyError(f"{handle} is not live in this registry (already "
                           "dropped, or invalidated by set_queries)")
        return np.nonzero(self.owner == handle.hid)[0]

    def update(self, handle: QueryHandle, qpos):
        rows = self.rows(handle)
        qpos = np.asarray(qpos, np.float32).reshape(-1, 2)
        if qpos.shape[0] != rows.shape[0]:
            raise ValueError(
                f"update_queries: {handle} owns {rows.shape[0]} rows, "
                f"got {qpos.shape[0]} positions"
            )
        self.qpos[rows] = qpos
        self._dirty = True

    def drop(self, handle: QueryHandle):
        keep = np.ones(self.nq, bool)
        keep[self.rows(handle)] = False
        self.qpos = self.qpos[keep]
        self.qid = self.qid[keep]
        self.owner = self.owner[keep]
        self._live.discard(handle.hid)
        self._dirty = True
        self.rows_changed = True

    def replace_all(self, qpos, qid=None):
        """Bulk staging: replaces every row and invalidates every handle."""
        qpos, qid = self._coerce(qpos, qid)
        self.qpos = qpos.copy()
        self.qid = qid.copy()
        self.owner = np.full((qpos.shape[0],), -1, np.int64)
        self._live = set()
        self._dirty = True
        self.rows_changed = True

    def staged(self):
        """(qpos_dev, qid_dev, nq, qids, owner), padded, on the device."""
        if self._dirty or self._staged is None:
            qpos_p, qid_p = pad_queries(self.qpos, self.qid, self.multiple)
            self._staged = (
                torch.tensor(qpos_p, dtype=torch.float32, device=self.device),
                torch.tensor(qid_p, dtype=torch.int32, device=self.device),
                self.nq,
                self.qid.copy(),
                self.owner.copy(),
            )
            self._dirty = False
        return self._staged


class KnnSession:
    """A live serving session: device-resident object + query state, ticked.

    ``device=None`` runs on the card (and raises without one); tests pass
    ``device="cpu"`` to run the plain PyTorch path.
    """

    def __init__(self, spec: ServiceSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.executor = resolve_executor(spec.backend, spec.precision)
        self.plan = resolve_plan(
            spec.plan, num_devices=spec.mesh_shape,
            partitioner=spec.partitioner, merge=spec.merge,
        )
        self._registry = _QueryRegistry(self.plan.pad_multiple(spec.chunk),
                                        self.device)
        self._positions = None  # (N, 2) f32 on the device, by object id
        self._index = None
        self._work_at_build: float | None = None
        self._tick = 0
        self._pending: deque[TickHandle] = deque()
        self._qcost = None
        # object-axis boundaries of the last submitted tick (device); None
        # until a tick returns them and after a rebuild re-ranks the objects
        self._obj_bounds = None
        # per-query boundary-seed weights: host mirror + padded device copy
        self._qweight_host: np.ndarray | None = None
        self._qweight_ver = 0
        self._qweight_staged = None  # (ver, padded_len, device tensor)
        # collect="stats": the sink queued behind each tick, and its memory
        # of the previous tick (reset with the cost EMA on a row-set change)
        self._sink = (StatsSink(self.plan.object_axis_size)
                      if spec.collect == "stats" else None)
        self._sink_state = None
        # True iff the positions buffer changed since the index was refreshed
        self._positions_dirty = True
        self._reset_pending()

    def _reset_pending(self):
        """Forget the delta since the last refresh.

        ``_pending_ids``: the sorted unique ids moved since then (None: not
        known, after a snapshot ingest or before the first build); the old
        positions live in ``_pending_old_batches``, gathered on the device
        before each scatter, and ``_pending_src`` holds each pending id's row
        of its first touch in their concatenation.
        """
        self._pending_ids: np.ndarray | None = None
        self._pending_src: np.ndarray | None = None
        self._pending_old_batches: list[torch.Tensor] = []
        self._pending_old_rows = 0

    # ------------------------------------------------------------ state views
    @property
    def tick(self) -> int:
        return self._tick

    @property
    def index(self):
        return self._index

    @property
    def num_objects(self) -> int:
        return 0 if self._positions is None else int(self._positions.shape[0])

    @property
    def query_count(self) -> int:
        return self._registry.nq

    # ------------------------------------------------------------ object state
    def ingest_objects(self, positions):
        """Full-snapshot ingest: replace all object positions ((N, 2), by id)."""
        positions = np.asarray(positions, np.float32)
        if positions.ndim != 2 or positions.shape[1] != 2:
            raise ValueError(f"positions must be (N, 2), got {positions.shape}")
        with tracing.span("hand_in.objects"):
            self._positions = torch.tensor(positions, dtype=torch.float32,
                                           device=self.device)
        self._positions_dirty = True
        self._reset_pending()  # the delta is unknown: a full refresh follows

    def update_objects(self, ids, positions):
        """Delta ingest: scatter ``positions[i]`` to object ``ids[i]`` on device.

        Duplicate ids in one batch resolve to the last observation; batches
        are padded to ``spec.delta_pad`` rows with the sentinel id ``N``.
        Under ``maintenance="incremental"`` the batch's ids join the pending
        set, each with its position as of the last refresh (the first touch
        since then wins).
        """
        with tracing.span("hand_in.objects"):
            self._update_objects(ids, positions)

    def _update_objects(self, ids, positions):
        if self._positions is None:
            raise RuntimeError("update_objects before ingest_objects: the "
                               "session has no object state to update")
        ids = np.asarray(ids, np.int32).reshape(-1)
        positions = np.asarray(positions, np.float32).reshape(-1, 2)
        if ids.shape[0] != positions.shape[0]:
            raise ValueError(f"update_objects: {ids.shape[0]} ids vs "
                             f"{positions.shape[0]} positions")
        m = ids.shape[0]
        if m == 0:
            return
        n = self.num_objects
        if (ids < 0).any() or (ids >= n).any():
            bad = ids[(ids < 0) | (ids >= n)]
            raise ValueError(f"update_objects: ids out of range [0, {n}): "
                             f"{bad[:8]}")
        if np.unique(ids).shape[0] != m:
            _, last_rev = np.unique(ids[::-1], return_index=True)
            keep = np.sort((m - 1) - last_rev)
            ids, positions = ids[keep], positions[keep]
            m = ids.shape[0]
        pad = pad_capacity(m, self.spec.delta_pad) - m
        if pad:
            ids = np.concatenate([ids, np.full((pad,), n, np.int32)])
            positions = np.concatenate([positions,
                                        np.zeros((pad, 2), np.float32)])
        ids_dev = torch.tensor(ids, device=self.device)
        pos_dev = torch.tensor(positions, device=self.device)
        tracking = self.spec.maintenance == "incremental" and not (
            self._positions_dirty and self._pending_ids is None)
        if tracking:
            # the positions before this batch's scatter, which writes in
            # place, in the host order of the deduped ids (before
            # route_delta reorders them); padding rows read row N - 1,
            # never used
            old_batch = self._positions[ids_dev.clamp(max=n - 1).long()]
        if self.plan.object_axis_size > 1 and self._index is not None:
            # grouped by owning object shard: a pure reorder of unique ids
            ids_dev, pos_dev = route_delta(
                self._index, ids_dev, pos_dev, self.plan.object_axis_size,
                self._obj_bounds,
            )
        self._positions = scatter_positions(self._positions, ids_dev, pos_dev)
        if tracking:
            moved = ids[:m]
            self._pending_old_batches.append(old_batch)
            src_batch = self._pending_old_rows + np.arange(m, dtype=np.int64)
            self._pending_old_rows += int(ids.shape[0])
            if self._pending_ids is None:
                order = np.argsort(moved)
                self._pending_ids = moved[order]
                self._pending_src = src_batch[order]
            else:
                # first touch wins for the old position; the id set is a
                # union, since an object moved twice is one moved row
                fresh = ~np.isin(moved, self._pending_ids)
                merged = np.union1d(self._pending_ids, moved)
                src = np.empty(merged.size, np.int64)
                src[np.searchsorted(merged, self._pending_ids)] = \
                    self._pending_src
                src[np.searchsorted(merged, moved[fresh])] = src_batch[fresh]
                self._pending_ids, self._pending_src = merged, src
        self._positions_dirty = True

    def object_shards(self, ids) -> np.ndarray:
        """Owning object shard per object id under the live plan and index.

        Pending ticks are finalized first: one may carry a drift rebuild,
        after which the Morton ranks, and so the owners, change.  Plans
        without an object axis own everything on shard 0.
        """
        ids = np.asarray(ids, np.int32).reshape(-1)
        r = self.plan.object_axis_size
        if r == 1:
            return np.zeros(ids.shape, np.int32)
        if self._index is None:
            raise RuntimeError(
                "object_shards before the first submit: the index (and with "
                "it the Morton shard ownership) is built lazily at submit()"
            )
        self._finalize_through()
        n = self._index.n_objects
        if ids.size and ((ids < 0).any() or (ids >= n).any()):
            bad = ids[(ids < 0) | (ids >= n)]
            raise ValueError(
                f"object_shards: ids outside the live index's [0, {n}): "
                f"{bad[:8]}"
            )
        return object_shard_of(
            self._index, torch.tensor(ids, device=self.device), r,
            self._obj_bounds,
        ).cpu().numpy()

    # ------------------------------------------------------------ query state
    def register_queries(self, qpos, qid=None) -> QueryHandle:
        """Add a persistent query group; ``qid`` is excluded from its result."""
        return self._registry.register(qpos, qid)

    def update_queries(self, handle: QueryHandle, qpos):
        """Move a registered group: same row count, new positions."""
        with tracing.span("hand_in.queries"):
            self._registry.update(handle, qpos)

    def drop_queries(self, handle: QueryHandle):
        """Remove a group; its rows stop being served from the next submit."""
        self._registry.drop(handle)

    def set_queries(self, qpos, qid=None):
        """Bulk staging of the whole query set; invalidates every handle."""
        self._registry.replace_all(qpos, qid)

    def set_query_cost_weights(self, weights):
        """Per-query multipliers on the boundary-seeding cost (or None).

        ``weights`` is (query_count,) f32 in the registry's row order, for
        example ``core.balance.tenant_fair_weights``.  They move query shard
        boundaries only, never results.  Re-set them after any change of the
        registry's row set (checked at submit).
        """
        if weights is None:
            self._qweight_host = None
        else:
            w = np.asarray(weights, np.float32).reshape(-1)
            if w.shape[0] != self._registry.nq:
                raise ValueError(
                    f"set_query_cost_weights: {w.shape[0]} weights for a "
                    f"{self._registry.nq}-row registry"
                )
            if w.size and not (np.isfinite(w).all() and (w > 0).all()):
                raise ValueError(
                    "set_query_cost_weights: weights must be finite and > 0"
                )
            self._qweight_host = w.copy()
        self._qweight_ver += 1
        self._qweight_staged = None

    def _staged_qweight(self, nq: int, cap: int):
        """The weights padded to ``cap`` rows on the device, or None.

        Padding rows clone the last query (``pad_queries``), so they clone
        its weight too.
        """
        if self._qweight_host is None:
            return None
        if self._qweight_host.shape[0] != nq:
            raise RuntimeError(
                "query cost weights are stale: the registry row set "
                "changed since set_query_cost_weights (re-set or clear)"
            )
        st = self._qweight_staged
        if st is None or st[0] != self._qweight_ver or st[1] != cap:
            w = self._qweight_host
            w_p = np.concatenate([w, np.full((cap - nq,), w[-1], np.float32)])
            self._qweight_staged = (
                self._qweight_ver, cap,
                torch.tensor(w_p, dtype=torch.float32, device=self.device),
            )
        return self._qweight_staged[2]

    # ------------------------------------------------------------ serving
    def _in_budget(self) -> bool:
        """A known pending delta within ``churn_budget`` x N, under an
        incremental spec."""
        return (self.spec.maintenance == "incremental"
                and self._pending_ids is not None
                and self._pending_ids.size
                <= self.spec.churn_budget * self.num_objects)

    def _assemble_delta(self):
        """(delta_ids, delta_old_pos) on the device for the pending set.

        The sorted pending ids padded to the ``delta_pad`` granularity with
        the sentinel id N, and each id's position as of the last refresh,
        one gather over the captured batches (padding rows read row 0).
        """
        n = self.num_objects
        m = self._pending_ids.size
        pad = pad_capacity(max(m, 1), self.spec.delta_pad) - m
        delta_ids = torch.tensor(
            np.concatenate([self._pending_ids, np.full((pad,), n, np.int32)]),
            device=self.device)
        sel = torch.tensor(np.concatenate(
            [self._pending_src, np.zeros((pad,), np.int64)]),
            device=self.device)
        batches = self._pending_old_batches
        cat = batches[0] if len(batches) == 1 else torch.cat(batches)
        return delta_ids, cat[sel]

    def _build(self):
        """(Re)build the space partition from the current device positions.

        Three routes to the same bits: a clean buffer (the index was
        refreshed from this very buffer) only needs the leaf partition
        re-decided (``rebuild_zmap``); a known in-budget delta under an
        incremental spec is spliced in first (``reindex_objects_delta``),
        then the same; anything else takes the full ``build_index``.
        """
        with tracing.span("refresh.build", device=True):
            if self._index is not None and not self._positions_dirty:
                self._index = rebuild_zmap(self._index)
            elif self._index is not None and self._in_budget():
                ids_dev, old_dev = self._assemble_delta()
                self._index = rebuild_zmap(reindex_objects_delta(
                    self._index, self._positions, ids_dev, old_dev))
            else:
                self._index = build_index(
                    self._positions,
                    torch.tensor(self.spec.origin, dtype=torch.float32,
                                 device=self.device),
                    torch.tensor(self.spec.side, dtype=torch.float32,
                                 device=self.device),
                    l_max=self.spec.l_max,
                    th_quad=self.spec.th_quad,
                )
        self._work_at_build = None  # set at the next tick's finalize
        # the boundaries index Morton ranks of the previous partition
        self._obj_bounds = None
        self._positions_dirty = False
        self._reset_pending()

    def _finalize_one(self, h: TickHandle):
        """Read the tick's two bookkeeping scalars and apply the drift policy."""
        with tracing.into(h._trace), tracing.span("result.finalize"):
            h._work = float(h._aux.stats.candidates)
            h._iterations = int(h._aux.stats.iterations)
            tracing.count("host.syncs", 2)
            if self._work_at_build is None:
                self._work_at_build = h._work
            else:
                tracing.count("host.syncs")
                if bool(h._should_rebuild):
                    self._build()
                    h._rebuilt_post = True
        h._finalized = True

    def _finalize_through(self, target: TickHandle | None = None):
        """Finalize pending ticks in submit order, up to ``target`` (or all)."""
        if target is not None and target._finalized:
            return
        while self._pending:
            h = self._pending.popleft()
            self._finalize_one(h)
            if h is target:
                break

    def finalize_pending(self):
        """Apply the drift policy of every still-pending tick, now."""
        self._finalize_through()

    def submit(self) -> TickHandle:
        """Queue one tick against the current object + query state."""
        if self._positions is None:
            raise RuntimeError("submit before ingest_objects: no object state")
        if self._registry.nq == 0:
            raise RuntimeError("submit with an empty query registry: "
                               "register_queries first")
        rec = tracing.open_tick(self.device)
        with tracing.into(rec), tracing.span("submit"):
            return self._submit(rec)

    def _submit(self, rec) -> TickHandle:
        self._finalize_through()
        t0 = time.perf_counter()
        built0 = build_seconds()
        rebuilt_pre = False
        if self._index is None:
            self._build()
            rebuilt_pre = True
        with tracing.span("submit.stage"):
            if self._registry.rows_changed:
                # both are row-aligned with the padded registry batch
                self._qcost = None
                self._sink_state = None
                self._registry.rows_changed = False
            qpos_dev, qid_dev, nq, qids, owner = self._registry.staged()
            qcost_dev = self._qcost
            if qcost_dev is None or qcost_dev.shape[0] != qpos_dev.shape[0]:
                qcost_dev = torch.zeros((qpos_dev.shape[0],),
                                        dtype=torch.float32,
                                        device=self.device)
            qweight_dev = self._staged_qweight(nq, int(qpos_dev.shape[0]))
        spec = self.spec
        # the maintenance decision, on the host: a clean buffer skips; a
        # known in-budget delta under an incremental spec splices; anything
        # else re-sorts every row (the z_map stays, so the drift trigger
        # fires as under rebuild)
        delta_ids = delta_old_pos = None
        if not self._positions_dirty:
            mode = "skip"
        elif self._in_budget():
            mode = "incremental"
            delta_ids, delta_old_pos = self._assemble_delta()
            # one shard past churn_budget x its owned rows defers the tick
            # (one bool read back; the earlier ticks are finalized already)
            if self.plan.object_axis_size > 1:
                tracing.count("host.syncs")
                if bool(shard_churn_over_budget(
                        self._index, delta_ids, self.plan.object_axis_size,
                        spec.churn_budget, self._obj_bounds)):
                    mode = "rebuild"
                    delta_ids = delta_old_pos = None
        else:
            mode = "rebuild"
        work = np.inf if self._work_at_build is None else self._work_at_build
        self._index, nn_idx, nn_dist, aux, should_rebuild = _tick_step(
            self._index,
            self._positions,
            qpos_dev,
            qid_dev,
            qcost_dev,
            torch.tensor(work, dtype=torch.float32, device=self.device),
            torch.tensor(spec.rebuild_factor, dtype=torch.float32,
                         device=self.device),
            qweight_dev,
            k=spec.k,
            window=spec.window,
            chunk=spec.chunk,
            max_nav=default_max_nav(spec.l_max),
            max_iters=spec.max_iters,
            executor=self.executor,
            plan=self.plan,
            maintenance=mode,
            delta_ids=delta_ids,
            delta_old_pos=delta_old_pos,
        )
        self._positions_dirty = False
        self._reset_pending()
        self._qcost = aux.qcost_next
        self._obj_bounds = (
            aux.object_bounds if self.plan.object_axis_size > 1 else None
        )
        agg = None
        if self._sink is not None:
            # queued behind the step on the same stream, fed the post-step
            # index and this tick's object boundaries
            if (self._sink_state is None
                    or self._sink_state.prev_idx.shape != nn_idx.shape):
                self._sink_state = self._sink.init(int(nn_idx.shape[0]),
                                                   spec.k, self.device)
            self._sink_state, agg = self._sink.update(
                self._sink_state, nn_idx, nn_dist, self._index,
                self._obj_bounds, nq)
        h = TickHandle(
            session=self,
            tick=self._tick,
            nn_idx=nn_idx,
            nn_dist=nn_dist,
            aux=aux,
            should_rebuild=should_rebuild,
            nq=nq,
            qids=qids,
            owner=owner,
            t0=t0,
            # the port's counterpart of a first-shape compile: the seconds
            # this submit spent building kernels (0 once built, and on the
            # CPU)
            compile_s=build_seconds() - built0,
            rebuilt_pre=rebuilt_pre,
            collect=spec.collect,
            agg=agg,
            maintenance=mode,
            trace=rec,
        )
        self._tick += 1
        self._pending.append(h)
        return h

    def process_tick(self, positions, qpos, qid=None):
        """Blocking snapshot convenience: ingest + set_queries + submit +
        result, with ``wall_s`` measured from the top of the call."""
        t0 = time.perf_counter()
        self.ingest_objects(positions)
        self.set_queries(qpos, qid)
        res = self.submit().result()
        return dataclasses.replace(
            res, wall_s=time.perf_counter() - t0 - res.compile_s)
