"""Result cache for overlapping hotspot queries (DESIGN.md §16).

A copy of the reference's ``repro/serve/cache.py`` (numpy only).

Tenants of one :class:`~repro_torch.serve.server.KnnServer` share one moving-object
world, and under hotspot workloads they ask about the SAME places: the cache
turns the second tenant's identical query into a host-side array copy instead
of device work.  The contract (grown from the AppLovin caching pattern in
SNIPPETS.md — results keyed on an index epoch, invalidated by ingest):

* **Key** = the tenant-agnostic query geometry — the exact float bit patterns
  of the query position plus the exclusion qid (qid is part of the result's
  definition: it removes the issuing object from its own list).  Tenants
  never appear in the key; a cached list is correct for ANY tenant asking
  the bitwise-same question, which is what makes sharing sound.
* **Epoch** = a monotone counter over *global* invalidations.  A bump
  atomically drops every entry (snapshot ingest always bumps; delta ingest
  bumps under ``invalidation="epoch"``, and under ``"spatial"`` only as the
  over-budget fallback).  No stale entry can survive a bump to be looked up.
* **Mutation** = a monotone counter over *world mutations* — bumped by any
  snapshot or delta ingest, and by nothing else.  Drift rebuilds re-sort the
  SAME positions, so they do not touch it.  Results computed while the
  mutation counter read *m* are only inserted if it still reads *m* when
  they materialize (the server's guard): an ingest racing an in-flight tick
  can only lose cached work, never poison the store — while a drift rebuild
  no longer discards the rebuilt tick's own fresh inserts.
* **Spatial eviction** (``invalidation="spatial"``): each entry additionally
  stores its query center and squared k-th distance; a delta ingest evicts
  exactly the entries whose closed k-th ball a moved row's old or new
  position stabs (:func:`repro_torch.core.quadtree.ball_stab_mask`) instead of
  clearing the store.
* **Values** are read-only ``(k,)`` numpy arrays; lookups hand back the
  stored arrays and assembly into per-tenant results always copies (fancy
  indexing), so no tenant can mutate what another is served.

Eviction is LRU at a fixed entry capacity.  ``capacity=0`` disables the
cache entirely (every lookup misses, inserts drop) — the server does this
under ``collect != "full"``, where neighbour lists never reach the host and
there is nothing host-side to cache; intra-tick dedup still works there.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

__all__ = ["CacheStats", "ResultCache"]


@dataclasses.dataclass
class CacheStats:
    """Counters over the cache's lifetime (monotone; epochs don't reset them).

    ``invalidations`` counts entries dropped by epoch bumps AND by spatial
    stab evictions (both are "a world change killed this entry"); plain LRU
    capacity pressure counts into ``evictions`` instead.
    """

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class ResultCache:
    """LRU store: geometry key bytes -> read-only (nn_idx, nn_dist, ball)."""

    def __init__(self, capacity: int = 65536):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self.epoch = 0
        self.mutation = 0
        self.last_invalidation: str | None = None
        self.stats = CacheStats()
        # key -> (nn_idx, nn_dist, center | None, kth2 | None)
        self._store: OrderedDict[bytes, tuple] = OrderedDict()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        return len(self._store)

    def bump_mutation(self) -> int:
        """Record a world mutation (ingest).  Does NOT drop entries — the
        caller pairs it with :meth:`bump_epoch` or :meth:`evict_keys` as its
        invalidation mode dictates; the counter's sole consumer is the
        server's insert guard (results staged under an older world are
        dropped on materialization)."""
        self.mutation += 1
        return self.mutation

    def bump_epoch(self, reason: str = "ingest") -> int:
        """Advance the epoch and drop every entry (see module docstring)."""
        self.epoch += 1
        self.last_invalidation = reason
        if self._store:
            self.stats.invalidations += len(self._store)
            self._store.clear()
        return self.epoch

    def evict_keys(self, keys, reason: str) -> int:
        """Spatially targeted invalidation: drop exactly ``keys``.

        Counts into ``stats.invalidations`` (these are world-change kills,
        not capacity pressure) and records ``reason`` like an epoch bump —
        but does NOT advance the epoch: surviving entries stay valid.
        """
        n = 0
        for key in keys:
            if self._store.pop(key, None) is not None:
                n += 1
        self.stats.invalidations += n
        self.last_invalidation = reason
        return n

    def geometry(self):
        """(keys, centers, kth2) over the live store, insertion-LRU order.

        ``centers`` is ``(E, 2)`` f32 and ``kth2`` ``(E,)`` f64 (squared
        ball radii, squared at insert time from the kernel's Euclidean
        k-th distance); entries
        inserted without ball geometry come back NaN, which
        :func:`~repro_torch.core.quadtree.ball_stab_mask` treats as always-stab —
        an entry the stab can't reason about is evicted, never kept.
        """
        keys = list(self._store.keys())
        centers = np.full((len(keys), 2), np.nan, np.float32)
        kth2 = np.full((len(keys),), np.nan, np.float64)
        for i, key in enumerate(keys):
            ent = self._store[key]
            if ent[2] is not None:
                centers[i] = ent[2]
                kth2[i] = ent[3]
        return keys, centers, kth2

    def lookup(self, key: bytes):
        """(nn_idx, nn_dist) for ``key`` if live, else None."""
        self.stats.lookups += 1
        ent = self._store.get(key)
        if ent is None:
            self.stats.misses += 1
            return None
        self._store.move_to_end(key)
        self.stats.hits += 1
        return ent[0], ent[1]

    def insert(self, key: bytes, nn_idx, nn_dist, center=None, kth_dist=None):
        """Store a result under ``key``; no-op when disabled.

        ``center`` (query position, f32 ``(2,)``) and ``kth_dist`` (the
        kernel's EUCLIDEAN k-th distance, its f32 value) are the entry's
        stab ball for spatial invalidation; the radius is squared here in
        f64 (exact for any f32 input) so the stab compares squared
        distances without a second rounding.  Omitting them is allowed and
        merely makes the entry always-evict under spatial mode.  Callers must have verified
        the mutation counter they computed under is still current (the
        server's materialization guard); the cache itself only promises that
        an epoch bump clears everything inserted before it.
        """
        if not self.enabled:
            return
        ii = np.array(nn_idx, np.int32, copy=True)
        dd = np.array(nn_dist, np.float32, copy=True)
        ii.setflags(write=False)
        dd.setflags(write=False)
        c = None
        r2 = None
        if center is not None and kth_dist is not None:
            c = np.array(center, np.float32, copy=True).reshape(2)
            c.setflags(write=False)
            r2 = np.float64(kth_dist) ** 2
        self._store[key] = (ii, dd, c, r2)
        self._store.move_to_end(key)
        self.stats.insertions += 1
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.stats.evictions += 1
