"""Handles — stable references to query groups and to submitted ticks.

Counterpart of ``repro/api/handles.py``.  ``submit()`` returns a
:class:`TickHandle` right after the tick's work is queued on the device;
``result()`` finalizes every earlier tick in submit order (so drift rebuilds
apply in tick order) and then copies this tick's lists to the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.ticks import TickResult

__all__ = ["QueryHandle", "TickHandle"]


@dataclasses.dataclass(frozen=True)
class QueryHandle:
    """Stable reference to a registered query group (``count`` rows)."""

    hid: int
    count: int


class TickHandle:
    """One submitted tick: queued device work + lazy host materialization."""

    def __init__(self, session, tick: int, nn_idx, nn_dist, aux,
                 should_rebuild, nq: int, qids: np.ndarray, owner: np.ndarray,
                 t0: float, submit_s: float, rebuilt_pre: bool,
                 maintenance: str = "rebuild"):
        self._session = session
        self.tick = tick
        self._nn_idx = nn_idx
        self._nn_dist = nn_dist
        self._aux = aux
        self._should_rebuild = should_rebuild
        self._nq = nq
        self._qids = qids
        self._owner = owner
        self._t0 = t0
        self.submit_s = submit_s
        self._rebuilt_pre = rebuilt_pre
        self._maintenance = maintenance
        self._event = None
        if nn_idx.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        # set by the session at finalize time
        self._finalized = False
        self._rebuilt_post = False
        self._work: float | None = None
        self._iterations: int | None = None
        self._result: TickResult | None = None

    @property
    def finalized(self) -> bool:
        """Has this tick's drift bookkeeping landed (finalize or result)?"""
        return self._finalized or self._result is not None

    @property
    def rebuilt_post(self) -> bool:
        """Did the drift check of THIS tick trigger a rebuild after it ran?"""
        return self._rebuilt_post

    def block_until_ready(self) -> "TickHandle":
        """Block until this tick's device work is done, with no transfer."""
        if self._result is None and self._event is not None:
            self._event.synchronize()
        return self

    def _tick_result(self, nn_idx, nn_dist, shard_cand, shard_it,
                     collect_s: float = 0.0) -> TickResult:
        return TickResult(
            tick=self.tick,
            nn_idx=nn_idx,
            nn_dist=nn_dist,
            rebuilt=self._rebuilt_pre or self._rebuilt_post,
            wall_s=time.perf_counter() - self._t0,
            candidates=self._work,
            iterations=self._iterations,
            qids=self._qids,
            shard_candidates=shard_cand,
            shard_iterations=shard_it,
            collect_s=collect_s,
            maintenance=self._maintenance,
        )

    def result(self, materialize: bool = True) -> TickResult:
        """Block until this tick's results are available (idempotent).

        ``materialize=False`` returns the lists as device tensors (sliced to
        the live rows) instead of host arrays.
        """
        if self._result is not None:
            return self._result
        self._session._finalize_through(self)
        nq = self._nq
        if not materialize:
            return self._tick_result(
                self._nn_idx[:nq], self._nn_dist[:nq],
                self._aux.shard_candidates, self._aux.shard_iterations,
            )
        self.block_until_ready()
        tc = time.perf_counter()
        nn_idx = self._nn_idx[:nq].cpu().numpy()
        nn_dist = self._nn_dist[:nq].cpu().numpy()
        shard_cand = self._aux.shard_candidates.cpu().numpy()
        shard_it = self._aux.shard_iterations.cpu().numpy()
        self._result = self._tick_result(
            nn_idx, nn_dist, shard_cand, shard_it,
            collect_s=time.perf_counter() - tc,
        )
        # release the device tensors
        self._nn_idx = self._nn_dist = self._aux = self._should_rebuild = None
        return self._result

    def result_for(self, handle: QueryHandle):
        """This tick's rows for one query group: (nn_idx, nn_dist, qids)."""
        res = self.result()
        rows = np.nonzero(self._owner == handle.hid)[0]
        return res.nn_idx[rows], res.nn_dist[rows], res.qids[rows]
