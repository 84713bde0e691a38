"""Handles — stable references to query groups and to submitted ticks.

Counterpart of ``repro/api/handles.py``.  ``submit()`` returns a
:class:`TickHandle` right after the tick's work is queued on the device;
``result()`` finalizes every earlier tick in submit order (so drift rebuilds
apply in tick order) and then copies to the host what the spec's ``collect``
mode asks for: the ``(Q, k)`` lists under ``"full"``, only the sink's
aggregates and the shard counters under ``"stats"``, nothing under
``"none"``.  ``TickResult.collect_s`` is the copy time that call paid, taken
after the device work has drained.  With :mod:`repro_torch.tracing` on,
``TickResult.trace`` holds the tick's spans and counters.

On the card every tensor that crosses lands in a pinned host block from
PyTorch's caching host allocator: one asynchronous copy each on the tick's
stream, then one wait, and the numpy arrays handed out are views of those
blocks.  An array keeps its block; once the caller drops the result, the
blocks return to the allocator's cache and a later tick reuses them without a
new ``cudaHostAlloc``.  A caller that keeps every result pins 256 MB a kept
1M-row tick under ``"full"``, the host memory the pageable arrays of ``.cpu()``
took before.  On the CPU each tensor is copied by ``.cpu()``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import tracing
from ..core.ticks import TickResult

__all__ = ["QueryHandle", "TickHandle"]


def _to_host(tensors) -> list[np.ndarray]:
    """The tensors as numpy arrays on the host, counting what blocks.

    On the CPU each ``.cpu()`` is a blocking read.  On the card each tensor
    is copied without blocking into a pinned block of the caching host
    allocator, on the current stream, the one the tick ran on, and one wait
    covers the copies.  Counters: ``collect.pinned``, the tensors copied into
    pinned blocks; ``collect.host_allocs``, the blocks the allocator had to
    create for them (its stats are read only while tracing is on).
    """
    if not tensors[0].is_cuda:
        tracing.count("host.syncs", len(tensors))
        return [t.cpu().numpy() for t in tensors]
    traced = tracing.enabled()
    if traced:
        made = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    if traced:
        tracing.count("collect.host_allocs", torch.cuda.host_memory_stats()
                      .get("num_host_alloc", 0) - made)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    tracing.count("host.syncs")
    tracing.count("collect.pinned", len(tensors))
    return [h.numpy() for h in host]


@dataclasses.dataclass(frozen=True)
class QueryHandle:
    """Stable reference to a registered query group (``count`` rows)."""

    hid: int
    count: int


class TickHandle:
    """One submitted tick: queued device work + lazy host materialization."""

    def __init__(self, session, tick: int, nn_idx, nn_dist, aux,
                 should_rebuild, nq: int, qids: np.ndarray, owner: np.ndarray,
                 t0: float, compile_s: float, rebuilt_pre: bool,
                 collect: str = "full", agg=None,
                 maintenance: str = "rebuild", trace=None):
        self._session = session
        self.tick = tick
        self._nn_idx = nn_idx
        self._nn_dist = nn_dist
        self._aux = aux
        self._should_rebuild = should_rebuild
        self._collect = collect
        self._agg = agg  # the sink's TickAggregates on the device ("stats")
        self._nq = nq
        self._qids = qids
        self._owner = owner
        self._t0 = t0
        self.compile_s = compile_s
        self._rebuilt_pre = rebuilt_pre
        self._maintenance = maintenance
        self._trace = trace  # the tick's tracing record, None tracing off
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
        self._result_dev: TickResult | None = None

    @property
    def finalized(self) -> bool:
        """Has this tick's drift bookkeeping landed (finalize or result)?"""
        return self._finalized or self._result is not None

    @property
    def rebuilt_post(self) -> bool:
        """Did the drift check of THIS tick trigger a rebuild after it ran?"""
        return self._rebuilt_post

    def done(self) -> bool:
        """Non-blocking: has this tick's device work finished?

        Queries the event recorded behind the tick's work (and the sink's);
        always True on the CPU, where the work ran inside ``submit()``.
        """
        if self._result is not None or self._event is None:
            return True
        return self._event.query()

    def block_until_ready(self) -> "TickHandle":
        """Block until this tick's device work is done, with no transfer."""
        if self._result is None and self._event is not None:
            self._event.synchronize()
        return self

    def _tick_result(self, nn_idx, nn_dist, shard_cand, shard_it,
                     collect_s: float = 0.0, aggregates=None,
                     trace=None) -> TickResult:
        return TickResult(
            tick=self.tick,
            nn_idx=nn_idx,
            nn_dist=nn_dist,
            rebuilt=self._rebuilt_pre or self._rebuilt_post,
            wall_s=time.perf_counter() - self._t0 - self.compile_s,
            candidates=self._work,
            iterations=self._iterations,
            compile_s=self.compile_s,
            qids=self._qids,
            shard_candidates=shard_cand,
            shard_iterations=shard_it,
            collect_s=collect_s,
            aggregates=aggregates,
            maintenance=self._maintenance,
            trace=trace,
        )

    def result(self, materialize: bool = True) -> TickResult:
        """Block until this tick's results are available (idempotent).

        Finalizes every earlier pending tick first, in submit order.  What
        crosses to the host is the spec's ``collect`` mode: ``"full"`` the
        ``(Q, k)`` lists and the shard counters; ``"stats"`` the sink's
        aggregates and the shard counters (``nn_idx``/``nn_dist`` None);
        ``"none"`` nothing (every field past the finalize bookkeeping None,
        ``collect_s`` 0).

        ``materialize=False`` returns, and caches, a result whose lists,
        counters and aggregates are device tensors (the lists sliced to the
        live rows); a later ``result()`` still materializes and releases
        them.
        """
        if self._result is not None:
            return self._result
        self._session._finalize_through(self)
        nq = self._nq
        if not materialize:
            if self._result_dev is None:
                self._result_dev = self._tick_result(
                    self._nn_idx[:nq], self._nn_dist[:nq],
                    self._aux.shard_candidates, self._aux.shard_iterations,
                    aggregates=self._agg,
                )
            return self._result_dev
        if self._collect == "none":
            self._result = self._tick_result(
                None, None, None, None, trace=tracing.finish(self._trace))
        else:
            # drain the device work outside the timed window: collect_s is
            # the copy alone, the span result.collect on the host's clock
            self.block_until_ready()
            with tracing.into(self._trace):
                tracing.count("host.syncs")
                with tracing.span("result.collect", device=True):
                    tc = time.perf_counter()
                    shards = (self._aux.shard_candidates,
                              self._aux.shard_iterations)
                    if self._collect == "stats":
                        shard_cand, shard_it, *copied = _to_host(
                            (*shards, *self._agg))
                        agg, lists = type(self._agg)(*copied), (None, None)
                    else:
                        agg = None
                        shard_cand, shard_it, *lists = _to_host(
                            (*shards, self._nn_idx[:nq], self._nn_dist[:nq]))
                    collect_s = time.perf_counter() - tc
            self._result = self._tick_result(
                *lists, shard_cand, shard_it, collect_s=collect_s,
                aggregates=agg, trace=tracing.finish(self._trace))
        # release the device tensors
        self._nn_idx = self._nn_dist = self._aux = self._should_rebuild = None
        self._agg = None
        self._result_dev = None
        return self._result

    def result_for(self, handle: QueryHandle):
        """This tick's rows for one query group: (nn_idx, nn_dist, qids).

        Rows come from the registry snapshot taken at submit.  Under
        ``collect != "full"`` the lists never reach the host, so the rows
        come back as device tensors (through ``result(materialize=False)``).
        """
        if self._collect == "full":
            res = self.result()
        else:
            res = self.result(materialize=False)
        if res.nn_idx is None:
            raise RuntimeError(
                f"result_for after result() under collect={self._collect!r}: "
                "the neighbour lists were never copied to the host and their "
                "device tensors are released; call result_for (or "
                "result(materialize=False)) before materializing")
        rows = np.nonzero(self._owner == handle.hid)[0]
        if torch.is_tensor(res.nn_idx):
            sel = torch.as_tensor(rows, device=res.nn_idx.device)
            return (res.nn_idx.index_select(0, sel),
                    res.nn_dist.index_select(0, sel), res.qids[rows])
        return res.nn_idx[rows], res.nn_dist[rows], res.qids[rows]
