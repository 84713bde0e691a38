"""TenantRegistry — the server's tenant-tagged logical query rows (DESIGN.md §16).

A copy of the reference's ``repro/serve/registry.py`` (numpy only).

The server keeps its OWN host-side registry above the session's: every
registered query row carries (geometry, exclusion qid, tenant, group handle).
Per tick the registry derives the **compute view** — the deduplicated set of
distinct (geometry, qid) keys across all tenants — and it is that unique set
(minus cache hits) that gets staged into the inner :class:`~repro_torch.api.KnnSession`
via ``set_queries``, padded by the same :func:`repro_torch.core.plan.pad_queries`
convention as any solo session.  Deduplication is sound for the same reason
the cache is: a result is a pure function of (object positions, query
geometry, qid) — the repo-wide exactness contract (canonical selection,
DESIGN.md §12) — so two tenants asking the bitwise-same question own the
bitwise-same answer.

Keys are the raw bit patterns (f32 position words + i32 qid), not float
comparisons: distinct NaN payloads or signed zeros never alias, and the
12-byte key doubles as the result-cache key.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ComputeView", "TenantRegistry"]

_KEY_DTYPE = np.dtype([("x", "<u4"), ("y", "<u4"), ("q", "<i4")])


def _geometry_keys(qpos: np.ndarray, qid: np.ndarray) -> np.ndarray:
    """(R,) structured key records from (R, 2) f32 positions + (R,) i32 qids."""
    rec = np.empty(qpos.shape[0], _KEY_DTYPE)
    rec["x"] = np.ascontiguousarray(qpos[:, 0], "<f4").view("<u4")
    rec["y"] = np.ascontiguousarray(qpos[:, 1], "<f4").view("<u4")
    rec["q"] = qid.astype("<i4")
    return rec


@dataclasses.dataclass(frozen=True)
class ComputeView:
    """One tick's dedup of the logical rows into distinct compute keys.

    ``qpos``/``qid`` are the (U,) unique rows in key-sorted order (rows of
    the ORIGINAL arrays, bit-exact); ``row_to_unique`` maps each logical
    registry row to its unique index; ``keys[u]`` is unique row *u*'s
    12-byte geometry key (the cache key).  ``qpos[u]`` doubles as cache
    entry *u*'s stab-ball center under spatial invalidation — it must stay
    the original f32 bits (NOT a re-rounded copy) so the zero-radius stab's
    bitwise-equality semantics hold.
    """

    qpos: np.ndarray
    qid: np.ndarray
    row_to_unique: np.ndarray
    keys: list

    @property
    def n_unique(self) -> int:
        return int(self.qpos.shape[0])


class TenantRegistry:
    """Contiguous tenant-tagged rows; groups drop by handle, tenants wholesale."""

    def __init__(self):
        self.qpos = np.zeros((0, 2), np.float32)
        self.qid = np.zeros((0,), np.int32)
        self.tenant = np.zeros((0,), np.int64)  # tenant id per row
        self.owner = np.zeros((0,), np.int64)   # group hid per row
        self._next_hid = 0
        self._live: set[int] = set()

    @property
    def nrows(self) -> int:
        return int(self.qpos.shape[0])

    def tenant_count(self, tid: int) -> int:
        return int((self.tenant == tid).sum())

    def _coerce(self, qpos, qid):
        qpos = np.asarray(qpos, np.float32).reshape(-1, 2)
        m = qpos.shape[0]
        if qid is None:
            qid = np.full((m,), -2, np.int32)
        else:
            qid = np.asarray(qid, np.int32).reshape(-1)
            if qid.shape[0] != m:
                raise ValueError(
                    f"qid has {qid.shape[0]} rows but qpos has {m}"
                )
        return qpos, qid

    def register(self, tid: int, qpos, qid=None) -> int:
        qpos, qid = self._coerce(qpos, qid)
        if qpos.shape[0] == 0:
            raise ValueError("cannot register an empty query group")
        hid = self._next_hid
        self._next_hid += 1
        m = qpos.shape[0]
        self.qpos = np.concatenate([self.qpos, qpos])
        self.qid = np.concatenate([self.qid, qid])
        self.tenant = np.concatenate([self.tenant, np.full((m,), tid, np.int64)])
        self.owner = np.concatenate([self.owner, np.full((m,), hid, np.int64)])
        self._live.add(hid)
        return hid

    def _check(self, hid: int):
        if hid not in self._live:
            raise KeyError(
                f"query group {hid} is not live (already dropped, or its "
                "tenant was evicted)"
            )

    def group_rows(self, hid: int) -> np.ndarray:
        self._check(hid)
        return np.nonzero(self.owner == hid)[0]

    def tenant_rows(self, tid: int) -> np.ndarray:
        return np.nonzero(self.tenant == tid)[0]

    def update(self, hid: int, qpos):
        rows = self.group_rows(hid)
        qpos = np.asarray(qpos, np.float32).reshape(-1, 2)
        if qpos.shape[0] != rows.shape[0]:
            raise ValueError(
                f"update: group {hid} owns {rows.shape[0]} rows, got "
                f"{qpos.shape[0]} positions"
            )
        self.qpos[rows] = qpos

    def _drop_rows(self, rows: np.ndarray):
        keep = np.ones(self.nrows, bool)
        keep[rows] = False
        self.qpos = self.qpos[keep]
        self.qid = self.qid[keep]
        self.tenant = self.tenant[keep]
        self.owner = self.owner[keep]

    def drop(self, hid: int):
        rows = self.group_rows(hid)
        self._drop_rows(rows)
        self._live.discard(hid)

    def drop_tenant(self, tid: int):
        rows = self.tenant_rows(tid)
        if rows.size:
            for hid in np.unique(self.owner[rows]):
                self._live.discard(int(hid))
            self._drop_rows(rows)

    def compute_view(self) -> ComputeView:
        """Dedup the logical rows into the distinct compute keys (docstring).

        ``np.unique`` on the structured keys sorts lexicographically on the
        bit patterns — a deterministic order, so an unchanged key SET stages
        an unchanged compute batch regardless of registration order, and the
        session's staged device arrays (and compiled programs) are reused.
        """
        keys = _geometry_keys(self.qpos, self.qid)
        uniq, first, inverse = np.unique(
            keys, return_index=True, return_inverse=True
        )
        return ComputeView(
            qpos=self.qpos[first].copy(),
            qid=self.qid[first].copy(),
            row_to_unique=inverse.reshape(-1).astype(np.int64),
            keys=[uniq[u].tobytes() for u in range(uniq.shape[0])],
        )
