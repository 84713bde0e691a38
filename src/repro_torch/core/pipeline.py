"""Iterative k-NN query computation (paper Sec. 4.2), in PyTorch.

Counterpart of ``repro/core/pipeline.py``.  All queries advance in lockstep;
per iteration each query either SCANs one W-wide window of candidates from its
current leaf (gather -> the executor's merge) or NAVigates the virtual full
quadtree with up to ``max_nav`` aligned-block jumps that skip empty or pruned
blocks (``kernels/nav_walk.py``: one CUDA kernel launch a pass on the card).

The reference's ``lax.while_loop`` is a Python loop that reads back, once per
iteration, which query rows are still live.  The sweep works on those rows
only: a row that is not live is a fixed point of the loop body (it scans an
empty window and takes no navigation step), so leaving it out changes no bit.
The same holds inside the navigation loop for rows that do not navigate.

Chunks: the query batch may be a whole number of ``n_chunks`` chunks that run
in lockstep, each with its own trip count, exactly as the reference runs its
``lax.map`` of per-chunk while loops.  A chunk stops counting iterations once
none of its rows is live, or at ``max_iters``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..kernels.nav_walk import nav_walk
from ..runtime import sqrt
from . import morton
from .executor import QueryExecutor, resolve_executor
from .quadtree import QuadtreeIndex

__all__ = [
    "knn_query_batch",
    "knn_query_batch_chunked",
    "default_max_nav",
    "KnnStats",
]


class KnnStats(NamedTuple):
    iterations: torch.Tensor  # i32 outer-loop trips (per chunk, or summed)
    candidates: torch.Tensor  # f32 candidate object slots scanned
    leaves_visited: torch.Tensor  # i32 scheduled leaf scans (incl. own leaf)


def _knn_sorted_impl(
    index: QuadtreeIndex,
    qpos: torch.Tensor,
    qid: torch.Tensor,
    k: int,
    window: int,
    max_nav: int,
    max_iters: int,
    executor: QueryExecutor,
    n_chunks: int = 1,
):
    """k-NN for Morton-sorted queries laid out as ``n_chunks`` equal chunks.

    Returns ``(best_i, best_d2, stats, cand_q)`` where ``stats`` holds (C,)
    per-chunk counters: each chunk's own trip count, its f32 sum of
    ``cand_q``, and its scheduled leaf scans.  Traced as the span ``sweep``;
    each pass of the loop as ``sweep.pass``, whose two blocking reads of the
    live rows are ``sweep.sync`` and whose window scan, timed on the device
    too, is ``sweep.scan``.  A pass with fewer live rows than one chunk (the
    lockstep's tail) counts ``sweep.tail_passes``.
    """
    with tracing.span("sweep", device=True):
        return _sweep(index, qpos, qid, k, window, max_nav, max_iters,
                      executor, n_chunks)


def _sweep(index, qpos, qid, k, window, max_nav, max_iters, executor,
           n_chunks):
    dev = qpos.device
    nq = qpos.shape[0]
    if nq % n_chunks:
        raise ValueError(f"{nq} queries do not split into {n_chunks} chunks")
    chunk = nq // n_chunks
    n_obj = index.n_objects
    n_fine = index.n_fine
    l_max = index.l_max
    i32 = torch.int32

    # --- first-iteration setup: query indexing (z_map lookup), own-leaf task
    fine = morton.morton_encode_points(qpos, index.origin, index.side, l_max)
    lvl = index.leaf_level[fine]
    shift = 2 * (l_max - lvl)
    key = (fine >> shift) << shift
    span = torch.bitwise_left_shift(torch.ones_like(shift), shift)
    s0 = index.starts[key]
    e0 = index.starts[(key + span).clamp(0, n_fine)]

    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=i32, device=dev)
    scanning = e0 > s0
    s_cur, e_cur = s0, e0
    off = torch.zeros((nq,), dtype=i32, device=dev)
    cl, cr = key, key + span
    act_l = torch.ones((nq,), dtype=torch.bool, device=dev)
    act_r = torch.ones((nq,), dtype=torch.bool, device=dev)
    next_right = torch.ones((nq,), dtype=torch.bool, device=dev)
    cand_q = torch.zeros((nq,), dtype=torch.float32, device=dev)
    it_c = torch.zeros((n_chunks,), dtype=i32, device=dev)
    leaves_c = scanning.view(n_chunks, chunk).sum(dim=1, dtype=i32)

    warange = torch.arange(window, dtype=i32, device=dev)

    while True:
        with tracing.span("sweep.pass"):
            live = scanning | act_l | act_r
            chunk_on = (live.view(n_chunks, chunk).any(dim=1)
                        & (it_c < max_iters))
            with tracing.span("sweep.sync"):
                rows = torch.nonzero(
                    live & chunk_on.repeat_interleave(chunk)
                ).squeeze(1)
            tracing.count("host.syncs")
            if rows.numel() == 0:
                break
            tracing.count("sweep.passes")
            tracing.count("sweep.rows", rows.numel())
            tracing.count("sweep.tail_passes", int(rows.numel() < chunk))
            it_c += chunk_on.to(i32)

            # ------------ SCAN: one window of W candidates per scanning row
            with tracing.span("sweep.scan", device=True):
                g_qpos = qpos[rows]
                g_scan = scanning[rows]
                g_s, g_e, g_off = s_cur[rows], e_cur[rows], off[rows]
                idx = g_s[:, None] + g_off[:, None] + warange[None, :]
                in_window = g_scan[:, None] & (idx < g_e[:, None])
                idxc = idx.clamp(0, n_obj - 1)
                cpos = index.pos[idxc]  # (R, W, 2)
                cids = index.ids[idxc]
                # negative ids are sentinels (-2: external queries)
                valid = in_window & (cids != qid[rows][:, None]) & (cids >= 0)
                g_bd, g_bi = executor.scan_merge(
                    g_qpos, cpos, cids, valid, best_d[rows], best_i[rows], k=k
                )
                best_d[rows] = g_bd
                best_i[rows] = g_bi
                kth2 = g_bd[:, k - 1]

                off2 = g_off + window
                leaf_done = g_s + off2 >= g_e
                g_scan_n = g_scan & ~leaf_done
                g_off = torch.where(g_scan_n, off2, g_off)
                cand_q[rows] = (cand_q[rows]
                                + in_window.sum(dim=1).to(torch.float32))

            # ------------ NAV: bounded frontier advance for idle active rows
            g_al, g_ar = act_l[rows], act_r[rows]
            nav = ~g_scan_n & (g_al | g_ar)
            found_any = torch.zeros_like(nav)
            with tracing.span("sweep.sync"):
                sub = torch.nonzero(nav).squeeze(1)
            tracing.count("host.syncs")
            if sub.numel():
                tracing.count("sweep.nav_rows", sub.numel())
                nrows = rows[sub]
                with tracing.span("sweep.nav"):
                    (n_cl, n_cr, n_al, n_ar, n_nr, n_s, n_e,
                     n_found) = nav_walk(
                        index, g_qpos[sub, 0], g_qpos[sub, 1], kth2[sub],
                        cl[nrows], cr[nrows], g_al[sub], g_ar[sub],
                        next_right[nrows], g_s[sub], g_e[sub], max_nav,
                    )
                cl[nrows], cr[nrows] = n_cl, n_cr
                act_l[nrows], act_r[nrows] = n_al, n_ar
                next_right[nrows] = n_nr
                g_s[sub], g_e[sub] = n_s, n_e
                found_any[sub] = n_found

            scanning[rows] = g_scan_n | found_any
            off[rows] = torch.where(found_any, 0, g_off).to(i32)
            s_cur[rows], e_cur[rows] = g_s, g_e
            leaves_c.index_add_(
                0, torch.div(rows, chunk, rounding_mode="floor"),
                found_any.to(i32))

    stats = KnnStats(
        iterations=it_c,
        candidates=cand_q.view(n_chunks, chunk).sum(dim=1),
        leaves_visited=leaves_c,
    )
    return best_i, best_d, stats, cand_q


def _sort_unsort(index: QuadtreeIndex, qpos: torch.Tensor):
    """Morton sort permutation of the queries and its inverse."""
    qcodes = morton.morton_encode_points(qpos, index.origin, index.side,
                                         index.l_max)
    order = torch.argsort(qcodes, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def default_max_nav(l_max: int) -> int:
    """Navigation steps bundled per iteration: enough to cross the domain."""
    return 2 * l_max + 4


def _resolve_max_nav(index: QuadtreeIndex, max_nav):
    return default_max_nav(index.l_max) if max_nav is None else max_nav


def knn_query_batch(
    index: QuadtreeIndex,
    qpos,
    qid=None,
    *,
    k: int = 32,
    window: int = 128,
    max_nav: int | None = None,
    max_iters: int = 100_000,
    backend: str | QueryExecutor | None = None,
):
    """k-NN of a query batch against the index, on the index's device.

    Returns ``(nn_idx (Q, k) i32, nn_dist (Q, k) f32 euclidean, stats)``,
    rows ascending by ``(distance, id)``, padded with ``(-1, inf)``.
    """
    dev = index.device
    qpos = torch.as_tensor(qpos, dtype=torch.float32).to(dev)
    nq = qpos.shape[0]
    if qid is None:
        qid = torch.full((nq,), -2, dtype=torch.int32, device=dev)
    else:
        qid = torch.as_tensor(qid, dtype=torch.int32).to(dev)
    executor = resolve_executor(backend)
    order, inv = _sort_unsort(index, qpos)
    idx_s, d2_s, st, _ = _knn_sorted_impl(
        index, qpos[order], qid[order], k, window,
        _resolve_max_nav(index, max_nav), max_iters, executor,
    )
    stats = KnnStats(st.iterations.sum(dtype=torch.int32),
                     st.candidates.sum(), st.leaves_visited.sum(dtype=torch.int32))
    return idx_s[inv], sqrt(d2_s[inv]), stats


def knn_query_batch_chunked(index, qpos, qid=None, **kw):
    """Delegates to :func:`repro_torch.core.plan.knn_query_batch_chunked`:
    chunking and device layout live behind the ExecutionPlan seam.  Kept
    here, as in the reference, so a test can pin that a tick never routes
    through this host-side chunk driver.  The import is lazy because
    ``plan.py`` imports this module."""
    from .plan import knn_query_batch_chunked as impl

    return impl(index, qpos, qid, **kw)
