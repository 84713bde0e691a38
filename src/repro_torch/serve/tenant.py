"""Tenant-facing handles: admission, quotas, and per-tenant ingest routing.

A copy of the reference's ``repro/serve/tenant.py``.

A :class:`TenantHandle` is what :meth:`~repro_torch.serve.server.KnnServer.admit`
returns — the ONLY object a tenant's client code needs.  It scopes query
registration (quota-checked), query movement, and delta object ingest to one
tenant while delegating every device interaction to the shared server.

Quota rule (DESIGN.md §16): a tenant may hold at most ``quota`` live query
rows.  Over-quota registration raises :class:`QuotaExceededError` by
default; ``clip=True`` degrades gracefully by registering only the first
``quota_remaining`` rows (the handle's ``count`` says how many survived).
Quotas bound *admission*, not fairness — fair share under the cost-balanced
partitioner is the per-row weighting (``core.balance.tenant_fair_weights``)
the server threads into boundary seeding, so even a tenant at a 10x larger
quota moves shard boundaries no more than any other.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "AdmissionError",
    "QuotaExceededError",
    "TenantQueryHandle",
    "TenantHandle",
]


class AdmissionError(RuntimeError):
    """The server refused admission (capacity, duplicate name, evicted)."""


class QuotaExceededError(AdmissionError):
    """Registration would exceed the tenant's live query-row quota."""


@dataclasses.dataclass(frozen=True)
class TenantQueryHandle:
    """Stable reference to one tenant's registered query group."""

    tenant: str
    hid: int
    count: int


class TenantHandle:
    """One admitted tenant's scoped view of the shared server."""

    def __init__(self, server, name: str, tid: int, quota: int | None):
        self._server = server
        self.name = name
        self.tid = tid
        self.quota = quota
        self.live = True
        self.deltas_fed = 0  # moved-object rows this tenant has ingested

    def __repr__(self):
        return (
            f"TenantHandle(name={self.name!r}, quota={self.quota}, "
            f"queries={self.query_count}, live={self.live})"
        )

    def _check_live(self):
        if not self.live:
            raise AdmissionError(f"tenant {self.name!r} was evicted")

    @property
    def query_count(self) -> int:
        """Live query rows this tenant currently holds."""
        return self._server._registry.tenant_count(self.tid)

    @property
    def quota_remaining(self) -> int | None:
        if self.quota is None:
            return None
        return max(0, self.quota - self.query_count)

    # ------------------------------------------------------------ queries
    def register_queries(self, qpos, qid=None, *, clip=False) -> TenantQueryHandle:
        """Add a persistent query group for this tenant (quota-checked).

        ``qid`` is the issuing object id per query (excluded from its own
        list; default -2 = none) — same convention as
        :meth:`repro_torch.api.KnnSession.register_queries`.  Raises
        :class:`QuotaExceededError` when the group would push the tenant
        over quota; ``clip=True`` registers the first ``quota_remaining``
        rows instead (still raising if none remain).
        """
        self._check_live()
        return self._server._register_queries(self, qpos, qid, clip=clip)

    def update_queries(self, handle: TenantQueryHandle, qpos):
        """Move a registered group: same row count, new positions."""
        self._check_live()
        self._server._update_queries(self, handle, qpos)

    def drop_queries(self, handle: TenantQueryHandle):
        """Remove a group; its rows stop being served from the next submit."""
        self._check_live()
        self._server._drop_queries(self, handle)

    # ------------------------------------------------------------ objects
    def update_objects(self, ids, positions):
        """Delta-ingest this tenant's observations into the SHARED world.

        All tenants observe one moving-object population; the delta rides
        the session's device-side scatter
        (:meth:`repro_torch.api.KnnSession.update_objects`) and — because the
        world changed — invalidates the result cache: the whole store
        under ``invalidation="epoch"``, only the stabbed entries under
        ``"spatial"`` (DESIGN.md §16).
        """
        self._check_live()
        self._server._ingest_delta(self, ids, positions)
