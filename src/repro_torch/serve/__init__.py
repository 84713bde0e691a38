"""repro_torch.serve — the multi-tenant serving layer above :class:`repro_torch.api.KnnSession`.

Counterpart of ``repro/serve``.  One :class:`KnnServer` admits many tenants
and coalesces their repeated k-NN queries into ONE shared tick of one
session: tenant-tagged rows in a unified registry, deduplicated by exact
query geometry, quota-checked at registration, fairness-weighted under the
cost-balanced partitioner, and replayed from an LRU result cache whose
invalidation is a knob — ``invalidation="epoch"`` clears the store on any
world movement, ``"spatial"`` evicts only the entries whose k-th-distance
ball a moved row stabs.  Per-tenant results are bitwise identical to what
a solo session would have produced (DESIGN.md §16).

    spec = ServiceSpec(k=8, side=1000.0, backend="fused_bucket")
    server = KnnServer(spec)                  # on the card; device="cpu" too
    server.ingest_objects(positions)          # ONE shared world
    alice = server.admit("alice", quota=512)
    bob = server.admit("bob")
    qa = alice.register_queries(alice_qpos)
    qb = bob.register_queries(bob_qpos)
    bob.update_objects(ids, moved)            # invalidates affected cache
    tickres = server.submit()                 # one device tick for everyone
    ii, dd, qids = tickres.result_for(qa)
"""
from .cache import CacheStats, ResultCache
from .registry import ComputeView, TenantRegistry
from .server import KnnServer, ServerTick, ServerTickResult
from .tenant import (
    AdmissionError,
    QuotaExceededError,
    TenantHandle,
    TenantQueryHandle,
)

__all__ = [
    "KnnServer",
    "ServerTick",
    "ServerTickResult",
    "TenantHandle",
    "TenantQueryHandle",
    "AdmissionError",
    "QuotaExceededError",
    "ResultCache",
    "CacheStats",
    "TenantRegistry",
    "ComputeView",
]
