"""KnnServer — many tenants, ONE shared tick program (DESIGN.md §16), in PyTorch.

Counterpart of ``repro/serve/server.py`` over the port's
:class:`~repro_torch.api.KnnSession`, on the session's one device.

The dataflow per tick:

1. **Admission** put tenants' query groups into the host-side
   :class:`~repro_torch.serve.registry.TenantRegistry` (tenant-tagged logical
   rows, quota-checked at registration).
2. ``submit()`` first *observes* any earlier in-flight tick's drift
   bookkeeping (``KnnSession.finalize_pending``) so drift decisions land
   BEFORE the cache is consulted (under ``invalidation="epoch"`` a rebuild
   bumps the epoch; under ``"spatial"`` it is a no-op — a rebuild re-sorts
   the SAME positions, so cached entries stay bit-correct).
3. The registry dedups the logical rows into distinct (geometry, qid) keys
   (:meth:`~repro_torch.serve.registry.TenantRegistry.compute_view`); each
   unique key is looked up in the :class:`~repro_torch.serve.cache.ResultCache`, whose
   invalidation mode is the server's ``invalidation`` knob: ``"epoch"``
   clears the store on every delta ingest; ``"spatial"`` evicts only the
   entries whose closed k-th-distance ball a moved row's old or new
   position stabs (:func:`repro_torch.core.quadtree.ball_stab_mask`), falling
   back to the epoch clear above ``stab_budget`` moved rows.
4. The **miss set** becomes the inner :class:`~repro_torch.api.KnnSession`'s query
   registry (``set_queries`` — only restaged when the miss set actually
   changed), with tenant-fair cost weights
   (``core.balance.tenant_fair_weights`` summed onto unique rows) threaded
   into the cost-balanced partitioner's boundary seeding, and ONE session
   tick is dispatched for all tenants together.  A tick whose unique rows
   are ALL cached skips the device entirely.
5. ``ServerTick.result_for(...)`` assembles each tenant's rows from the
   computed batch + cached entries by the row→unique mapping snapshotted at
   submit (always a copy — no tenant can mutate another's lists).

**Bit-identity argument** (the acceptance bar): a k-NN result here is a pure
function of (object positions, query geometry, exclusion qid) — canonical
selection makes every plan × partitioner × backend bitwise-equal to the
single-plan sweep (DESIGN.md §12/§13), so neither batch composition, nor
dedup, nor fairness-weighted boundaries, nor cache replay can change a
row's bits.  The inner session pads with the same
:func:`repro_torch.core.plan.pad_queries` the solo path uses; a cached entry is
the bits a solo session produced for that geometry under object positions
that are — by the invalidation contract (epoch clear, or the conservative
closed-ball stab) — still current for that entry.  Hence N tenants through
one server ≡ N solo sessions, row for row (pinned against the reference's
server and against solo sessions by tests/test_torch_serve.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..api.session import KnnSession
from ..api.spec import ServiceSpec
from ..core.balance import tenant_fair_weights
from ..core.quadtree import ball_stab_mask

from .cache import ResultCache
from .registry import TenantRegistry
from .tenant import (
    AdmissionError,
    QuotaExceededError,
    TenantHandle,
    TenantQueryHandle,
)

__all__ = ["KnnServer", "ServerTick", "ServerTickResult"]


@dataclasses.dataclass(frozen=True)
class ServerTickResult:
    """One shared tick's host-facing record (per-tenant rows come from
    ``ServerTick.result_for``; this is the accounting view).

    ``rows_total`` counts logical tenant rows served; ``rows_computed`` the
    unique keys that actually ran on device.  ``hit_rate`` is the fraction
    of logical rows served WITHOUT fresh device work —
    ``dedup_hit_rows`` (duplicates folded into a computed unique row, any
    collect mode) plus ``cache_hit_rows`` (rows replayed from a previous
    tick's still-valid entry, ``collect="full"`` only).  ``inner`` is the
    underlying session :class:`~repro_torch.core.ticks.TickResult` (None for a
    pure-cache tick that never touched the device).

    ``wall_s`` is the tick's attributable latency, decomposed so that host
    idle time between ``submit()`` and a lazy ``result()`` (or an
    overlapped τ+1 submit) never inflates it::

        wall_s = submit_s + drain_s + assemble_s

    * ``submit_s`` — host-side staging inside ``submit()`` (observe +
      dedup + cache probe + query restage + dispatch), compile excluded;
    * ``drain_s``  — blocking wait for the device work
      (``TickHandle.block_until_ready``) paid by THIS ``result()`` call;
    * ``assemble_s`` — host materialization + row/cache bookkeeping.

    All three are clamped >= 0; ``compile_s`` (the kernel build inside the
    inner session's ``submit()``, first use only) is reported separately, as
    in the inner session result.
    """

    tick: int
    epoch: int
    rows_total: int
    rows_unique: int
    rows_computed: int
    dedup_hit_rows: int
    cache_hit_rows: int
    rebuilt: bool
    wall_s: float
    compile_s: float
    inner: object
    submit_s: float = 0.0
    drain_s: float = 0.0
    assemble_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        if self.rows_total == 0:
            return 0.0
        return (self.dedup_hit_rows + self.cache_hit_rows) / self.rows_total


class ServerTick:
    """One submitted shared tick: the session handle + the row assembly maps."""

    def __init__(self, server, tick, handle, view, compute_idx, u_src,
                 cached_i, cached_d, owner, tenant, qid, epoch, mutation,
                 submit_s):
        self._server = server
        self.tick = tick
        self._handle = handle          # session TickHandle | None (pure cache)
        self._view = view              # ComputeView snapshot
        self._compute_idx = compute_idx  # (Uc,) unique indices sent to device
        self._u_src = u_src            # (U,) >=0: computed row j; <0: cached -(c+1)
        self._cached_i = cached_i      # (C, k) stacked cache hits (host)
        self._cached_d = cached_d
        self._owner = owner            # registry snapshots at submit
        self._tenant = tenant
        self._qid = qid
        self._epoch = epoch            # cache epoch at submit
        self._mutation = mutation      # world-mutation counter at submit
        self._submit_s = submit_s      # staging wall inside submit(), incl compile
        self._observed = False         # drift bookkeeping folded into the cache
        self._inserted = False
        self._res: ServerTickResult | None = None
        self._inner = None

    def done(self) -> bool:
        return self._handle is None or self._handle.done()

    def result(self) -> ServerTickResult:
        """Materialize the shared tick (idempotent; see ServerTickResult)."""
        if self._res is not None:
            return self._res
        srv = self._server
        rebuilt = False
        compile_s = 0.0
        drain_s = 0.0
        if self._handle is not None:
            # drain the device computation in its own timed window: host
            # idle between submit() and this call is nobody's latency, and
            # the drain is the only part that scales with device work
            td = time.perf_counter()
            self._handle.block_until_ready()
            drain_s = max(0.0, time.perf_counter() - td)
        ta = time.perf_counter()
        if self._handle is not None:
            if srv.spec.collect == "full":
                self._inner = self._handle.result()
            else:
                self._inner = self._handle.result(materialize=False)
            rebuilt = self._inner.rebuilt
            compile_s = self._inner.compile_s
        srv._observe(self)
        # insert fresh results only if the world has not MUTATED since
        # submit (ingest bumps the mutation counter; a drift rebuild — same
        # positions, new sort order — deliberately does not): an ingest
        # racing this tick loses cached work, never poisons the store
        if (
            not self._inserted
            and self._inner is not None
            and self._inner.nn_idx is not None
            and srv.spec.collect == "full"
            and srv.cache.enabled
            and srv.cache.mutation == self._mutation
        ):
            keys = self._view.keys
            qpos = self._view.qpos
            kth = self._inner.kth_dist
            for j, u in enumerate(self._compute_idx):
                srv.cache.insert(
                    keys[u], self._inner.nn_idx[j], self._inner.nn_dist[j],
                    center=qpos[u], kth_dist=kth[j],
                )
            self._inserted = True
        R = int(self._owner.shape[0])
        U = self._view.n_unique
        Uc = int(self._compute_idx.shape[0])
        rows_per_u = np.bincount(
            self._view.row_to_unique, minlength=U
        ) if R else np.zeros((U,), np.int64)
        cache_rows = int(rows_per_u[self._u_src < 0].sum())
        # compile happens synchronously inside submit() (first-shape
        # dispatch), so it comes out of the submit window only
        assemble_s = max(0.0, time.perf_counter() - ta)
        submit_s = max(0.0, self._submit_s - compile_s)
        self._res = ServerTickResult(
            tick=self.tick,
            epoch=self._epoch,
            rows_total=R,
            rows_unique=U,
            rows_computed=Uc,
            dedup_hit_rows=(R - cache_rows) - Uc,
            cache_hit_rows=cache_rows,
            rebuilt=rebuilt,
            wall_s=submit_s + drain_s + assemble_s,
            compile_s=compile_s,
            inner=self._inner,
            submit_s=submit_s,
            drain_s=drain_s,
            assemble_s=assemble_s,
        )
        return self._res

    def _rows_for(self, rows: np.ndarray):
        """Assemble (nn_idx, nn_dist, qids) for a set of snapshot rows.

        Every path copies (fancy indexing / ``index_select``): callers own
        their arrays, cached entries stay read-only — no cross-tenant
        aliasing.
        """
        self.result()
        us = self._view.row_to_unique[rows]
        src = self._u_src[us]
        qids = self._qid[rows].copy()
        inner = self._inner
        if self._server.spec.collect != "full":
            # cache disabled here, so every unique row was computed: a
            # gather on the device from the (materialize=False) result
            if inner is None or inner.nn_idx is None:
                raise RuntimeError(
                    "result_for after the device buffers were released "
                    f"(collect={self._server.spec.collect!r})"
                )
            sel = torch.as_tensor(src, device=inner.nn_idx.device)
            return (inner.nn_idx.index_select(0, sel),
                    inner.nn_dist.index_select(0, sel), qids)
        k = self._server.spec.k
        out_i = np.empty((rows.shape[0], k), np.int32)
        out_d = np.empty((rows.shape[0], k), np.float32)
        comp = src >= 0
        if comp.any():
            out_i[comp] = inner.nn_idx[src[comp]]
            out_d[comp] = inner.nn_dist[src[comp]]
        if (~comp).any():
            c = -(src[~comp]) - 1
            out_i[~comp] = self._cached_i[c]
            out_d[~comp] = self._cached_d[c]
        return out_i, out_d, qids

    def result_for(self, handle: TenantQueryHandle):
        """This tick's rows for one tenant query group: (nn_idx, nn_dist, qids).

        Row selection uses the registry snapshot taken at submit, so the
        mapping stays correct even if the group moved or dropped afterwards.
        """
        rows = np.nonzero(self._owner == handle.hid)[0]
        if rows.size == 0:
            raise KeyError(
                f"{handle} owned no rows when tick {self.tick} was submitted"
            )
        return self._rows_for(rows)

    def result_for_tenant(self, tenant: TenantHandle):
        """All of one tenant's rows this tick (registration order)."""
        rows = np.nonzero(self._tenant == tenant.tid)[0]
        return self._rows_for(rows)


class KnnServer:
    """Admit tenants, coalesce their queries into one session's shared ticks.

    Construct from the same :class:`~repro_torch.api.ServiceSpec` a solo
    session takes — the spec IS the shared tick program (plan, partitioner,
    backend, collect mode).  ``device`` is the inner session's (None: the
    card, raising without one).  ``max_tenants`` bounds admission;
    ``default_quota`` applies to tenants admitted without an explicit one
    (None = unbounded); ``cache_entries`` sizes the result cache (it is
    auto-disabled under ``collect != "full"``, where neighbour lists never
    reach the host — intra-tick dedup still shares device work there).

    ``invalidation`` selects the cache-invalidation mode (DESIGN.md §16):

    * ``"epoch"`` (default) — any delta ingest clears the whole store;
    * ``"spatial"`` — a delta ingest evicts only entries whose closed
      k-th-distance ball a moved row's old or new position stabs
      (:func:`repro_torch.core.quadtree.ball_stab_mask`); deltas larger than
      ``stab_budget`` rows fall back to the epoch clear, and deltas up to
      ``stab_exact_rows`` use the exact pairwise check instead of the
      Morton cell-ball cover.  Requires a host mirror of object positions
      (kept only in this mode, refreshed per ingest) to recover each moved
      row's OLD position without a device round-trip.

    In both modes drift rebuilds leave the cache alone as a *store of
    inserts*: the insert guard is keyed on the world-mutation counter
    (bumped by ingests only), so a rebuilt tick's own fresh results are
    kept — a rebuild re-sorts the same positions and cannot change any
    row's bits.  Under ``"epoch"`` a rebuild still bumps the epoch (the
    historical conservative hygiene, observable in ``cache.epoch``); under
    ``"spatial"`` it is a no-op.
    """

    def __init__(self, spec: ServiceSpec, *, device=None,
                 max_tenants: int | None = None,
                 default_quota: int | None = None, cache_entries: int = 65536,
                 fair_share: bool = True, invalidation: str = "epoch",
                 stab_budget: int = 4096, stab_exact_rows: int = 64):
        if invalidation not in ("epoch", "spatial"):
            raise ValueError(
                f"invalidation must be 'epoch' or 'spatial', got "
                f"{invalidation!r}"
            )
        if stab_budget < 0 or stab_exact_rows < 0:
            raise ValueError("stab_budget and stab_exact_rows must be >= 0")
        self.spec = spec
        self.session = KnnSession(spec, device=device)
        self.cache = ResultCache(
            capacity=cache_entries if spec.collect == "full" else 0
        )
        self.invalidation = invalidation
        self.stab_budget = int(stab_budget)
        self.stab_exact_rows = int(stab_exact_rows)
        # host mirror of object positions (spatial mode + enabled cache
        # only): the stab needs each moved row's OLD position, and reading
        # it back from the device would serialize ingest on the tick queue
        self._world: np.ndarray | None = None
        self.fair_share = fair_share
        self.max_tenants = max_tenants
        self.default_quota = default_quota
        self._registry = TenantRegistry()
        self._tenants: dict[str, TenantHandle] = {}
        self._next_tid = 0
        self._tick = 0
        self._inflight: deque[ServerTick] = deque()
        self._staged_sig: bytes | None = None
        self._staged_w: np.ndarray | None = None
        self.rows_served = 0
        self.rows_computed = 0

    # ------------------------------------------------------------ state views
    @property
    def tick(self) -> int:
        return self._tick

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def query_count(self) -> int:
        """Logical tenant query rows (>= the deduped device batch)."""
        return self._registry.nrows

    @property
    def num_objects(self) -> int:
        return self.session.num_objects

    def describe(self) -> str:
        return (
            f"server tenants={len(self._tenants)} rows={self.query_count} "
            f"cache={'off' if not self.cache.enabled else self.cache.capacity} "
            f"inval={self.invalidation} epoch={self.cache.epoch} | "
            f"{self.session.plan.describe()}"
        )

    # ------------------------------------------------------------ admission
    def admit(self, name: str, quota: int | None = None) -> TenantHandle:
        """Admit a tenant by unique name; returns its scoped handle."""
        if name in self._tenants:
            raise AdmissionError(f"tenant {name!r} is already admitted")
        if self.max_tenants is not None and len(self._tenants) >= self.max_tenants:
            raise AdmissionError(
                f"server is at max_tenants={self.max_tenants}"
            )
        if quota is None:
            quota = self.default_quota
        if quota is not None and quota < 1:
            raise ValueError(f"quota must be >= 1, got {quota}")
        t = TenantHandle(self, name, self._next_tid, quota)
        self._next_tid += 1
        self._tenants[name] = t
        return t

    def evict(self, tenant: TenantHandle):
        """Drop a tenant and every query row it registered.

        Cached results stay: they are keyed on tenant-agnostic geometry and
        remain bit-correct answers for any tenant at the current epoch.
        """
        if self._tenants.get(tenant.name) is not tenant:
            raise AdmissionError(f"tenant {tenant.name!r} is not admitted here")
        self._registry.drop_tenant(tenant.tid)
        del self._tenants[tenant.name]
        tenant.live = False

    # ------------------------------------------------------------ world state
    @property
    def _mirror_world(self) -> bool:
        return self.invalidation == "spatial" and self.cache.enabled

    def ingest_objects(self, positions):
        """Seed/replace the SHARED object world (snapshot path); bumps epoch.

        A snapshot replaces every position, so both modes clear the store
        (a stab against N moved rows is the epoch clear's work for no
        savings).
        """
        self.session.ingest_objects(positions)
        self.cache.bump_mutation()
        self.cache.bump_epoch("snapshot-ingest")
        if self._mirror_world:
            self._world = np.array(positions, np.float32).reshape(-1, 2)

    def _ingest_delta(self, tenant: TenantHandle, ids, positions):
        ids_a = np.asarray(ids, np.int64).reshape(-1)
        m = ids_a.shape[0]
        # the session validates ids/shapes first — an invalid delta must
        # not invalidate anything
        self.session.update_objects(ids, positions)
        if not m:
            return
        tenant.deltas_fed += m
        self.cache.bump_mutation()
        if self.invalidation == "spatial":
            self._invalidate_delta(
                ids_a, np.asarray(positions, np.float32).reshape(-1, 2),
                tenant.name,
            )
        else:
            self.cache.bump_epoch(f"delta-ingest:{tenant.name}")

    def _invalidate_delta(self, ids: np.ndarray, new_pos: np.ndarray,
                          name: str):
        """Spatial invalidation for one delta batch (already validated).

        Evicts exactly the entries whose closed k-th ball contains a moved
        row's old (host mirror) or new position; a batch over
        ``stab_budget`` rows falls back to the epoch clear (reason
        ``stab-budget:<tenant>``).  The mirror is updated keep-last per id,
        matching the session's scatter semantics, BEFORE the early returns
        so it never goes stale.
        """
        cache = self.cache
        if not cache.enabled:
            return
        # keep-last dedup: only the last occurrence of an id lands, and its
        # old position is the pre-batch mirror value (intermediate
        # positions within one batch never exist on device)
        _, keep_rev = np.unique(ids[::-1], return_index=True)
        sel = ids.shape[0] - 1 - keep_rev
        ids_u = ids[sel]
        new_u = new_pos[sel]
        if self._world is None:
            # no snapshot observed since spatial mode needed it (shouldn't
            # happen: ingest precedes deltas) — conservative full clear
            cache.bump_epoch(f"stab-nomirror:{name}")
            return
        old_u = self._world[ids_u].copy()
        self._world[ids_u] = new_u
        if ids_u.shape[0] > self.stab_budget:
            cache.bump_epoch(f"stab-budget:{name}")
            return
        keys, centers, kth2 = cache.geometry()
        if not keys:
            cache.last_invalidation = f"delta-stab:{name}"
            return
        mask = ball_stab_mask(
            centers, kth2, np.concatenate([old_u, new_u]),
            origin=np.asarray(self.spec.origin, np.float64),
            side=self.spec.side, l_max=self.spec.l_max,
            exact_rows=self.stab_exact_rows,
        )
        cache.evict_keys(
            [k for k, m in zip(keys, mask) if m], f"delta-stab:{name}"
        )

    # ------------------------------------------------------------ queries
    def _register_queries(self, tenant: TenantHandle, qpos, qid, *,
                          clip: bool) -> TenantQueryHandle:
        qpos = np.asarray(qpos, np.float32).reshape(-1, 2)
        m = qpos.shape[0]
        if qid is not None:
            qid = np.asarray(qid, np.int32).reshape(-1)
        remaining = tenant.quota_remaining
        if remaining is not None and m > remaining:
            if not clip or remaining == 0:
                raise QuotaExceededError(
                    f"tenant {tenant.name!r}: registering {m} rows would "
                    f"exceed quota {tenant.quota} "
                    f"({tenant.query_count} live, {remaining} remaining)"
                )
            qpos = qpos[:remaining]
            qid = None if qid is None else qid[:remaining]
            m = remaining
        hid = self._registry.register(tenant.tid, qpos, qid)
        return TenantQueryHandle(tenant=tenant.name, hid=hid, count=m)

    def _check_owner(self, tenant: TenantHandle, handle: TenantQueryHandle):
        if handle.tenant != tenant.name:
            raise KeyError(
                f"{handle} belongs to tenant {handle.tenant!r}, not "
                f"{tenant.name!r}"
            )

    def _update_queries(self, tenant, handle, qpos):
        self._check_owner(tenant, handle)
        self._registry.update(handle.hid, qpos)

    def _drop_queries(self, tenant, handle):
        self._check_owner(tenant, handle)
        self._registry.drop(handle.hid)

    # ------------------------------------------------------------ serving
    def _observe(self, st: ServerTick):
        """Fold one finalized tick's drift decision into the cache.

        A drift rebuild re-sorts the SAME positions, so already-cached
        entries are still bit-correct.  Under ``invalidation="epoch"`` the
        bump is the historical conservative hygiene; under ``"spatial"``
        nothing happens — no position changed, no ball was stabbed.  In
        BOTH modes the rebuild leaves the world-mutation counter alone, so
        the rebuilt tick's own fresh inserts are kept (the insert guard
        keys on mutation, not epoch).  The initial lazy build
        (``rebuilt_pre`` of tick 0) is not a drift decision and does not
        bump.
        """
        if st._observed:
            return
        h = st._handle
        if h is not None and not h.finalized:
            return  # not finalized yet; observed again later
        st._observed = True
        if h is not None and h.rebuilt_post and self.invalidation == "epoch":
            self.cache.bump_epoch("drift-rebuild")

    def submit(self) -> ServerTick:
        """Dispatch ONE shared tick for every admitted tenant's queries.

        Returns immediately after staging + dispatch (or instantly for a
        pure-cache tick); ``ServerTick.result()`` / ``result_for`` block.
        """
        if self._registry.nrows == 0:
            raise RuntimeError(
                "submit with no registered tenant queries: admit tenants and "
                "register_queries first"
            )
        t0 = time.perf_counter()
        # drift decisions of earlier ticks must land before the cache read
        self.session.finalize_pending()
        while self._inflight:
            st = self._inflight[0]
            self._observe(st)
            if not st._observed:
                break
            self._inflight.popleft()
        view = self._registry.compute_view()
        U = view.n_unique
        u_src = np.empty((U,), np.int64)
        compute_idx = []
        cached_entries = []
        for u, key in enumerate(view.keys):
            ent = self.cache.lookup(key) if self.cache.enabled else None
            if ent is None:
                u_src[u] = len(compute_idx)
                compute_idx.append(u)
            else:
                u_src[u] = -(len(cached_entries) + 1)
                cached_entries.append(ent)
        compute_idx = np.asarray(compute_idx, np.int64)
        k = self.spec.k
        if cached_entries:
            cached_i = np.stack([e[0] for e in cached_entries])
            cached_d = np.stack([e[1] for e in cached_entries])
        else:
            cached_i = np.zeros((0, k), np.int32)
            cached_d = np.zeros((0, k), np.float32)
        epoch = self.cache.epoch
        mutation = self.cache.mutation
        handle = None
        if compute_idx.size:
            sig = b"".join(view.keys[u] for u in compute_idx)
            w = None
            if self.fair_share:
                # each tenant's total boundary-seeding influence is equal;
                # duplicate rows SUM their owners' shares onto the one
                # computed unique row (shared work, shared influence)
                w_row = tenant_fair_weights(self._registry.tenant)
                w_u = np.zeros((U,), np.float32)
                np.add.at(w_u, view.row_to_unique, w_row)
                w = w_u[compute_idx]
            if sig != self._staged_sig:
                self.session.set_queries(
                    view.qpos[compute_idx], view.qid[compute_idx]
                )
                self.session.set_query_cost_weights(w)
                self._staged_sig, self._staged_w = sig, w
            elif not (
                w is None and self._staged_w is None
            ) and not np.array_equal(w, self._staged_w):
                self.session.set_query_cost_weights(w)
                self._staged_w = w
            handle = self.session.submit()
        st = ServerTick(
            self, self._tick, handle, view, compute_idx, u_src,
            cached_i, cached_d,
            self._registry.owner.copy(), self._registry.tenant.copy(),
            self._registry.qid.copy(), epoch, mutation,
            time.perf_counter() - t0,
        )
        self._tick += 1
        self._inflight.append(st)
        self.rows_served += self._registry.nrows
        self.rows_computed += int(compute_idx.size)
        return st
