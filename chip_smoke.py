#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                 # the full run (1M objects)
    python3 chip_smoke.py --n-objects 20000 --short-api --ptxas  # first check

Phases, in order; any failure raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port, ``nvcc`` runs in parallel on the
   host while phases 17 and 18 (the LM harness, which reaches no kernel)
   run on the card; phase 3 and the rest follow in order once it ends;
3. fma: ``torch.addcmul`` (the port's spelling of a fused multiply-add) held
   against an exact round-to-odd emulation on the card;
4. kernel: ``fused_scan_merge``, fp32 and ``precision="mixed"``, on the card
   against its plain PyTorch version on the same inputs (W=256, k=32 with
   edge rows, NaN and negative rows, lists in any order; Q = 8192 and
   Q = 1,007,616, the 1M path's first trip, in row blocks), bitwise; equal
   to the exact ``dense_topk`` merge, and mixed to fp32, on the rows inside
   their premise; timed beside its memory bound, that merge and the plain
   version;
5. merge kernels: ``merge_topk_multi`` at Q = 1,007,616, R = 4, k = 32 and
   ``merge_topk_lists`` at Q = 503,808 (ka = kb = 32, and ka = 20, kb = 32),
   with edge rows (ties across lists, pairs equal across lists, empty,
   partly filled and (inf, id)-padded lists), each bitwise against its
   plain version and the two-sort merge of ``dense_merge`` on the card, and
   timed beside its memory bound and that two-sort merge;
6. wide templates (:func:`wide_kernel_phase`), past the narrow templates'
   widths: B1 fp32 and mixed at Q = 8192 with W = 1024, k = 32 and W = 256,
   k = 512 on :func:`kernel_inputs`' bands; B2 at R = 8, k = 128 and B3 at
   ka = kb = k = 384 (both the wide merge) with NaN, -inf, -0, negative and
   unsorted-list bands; each bitwise against its plain version and timed;
   then the navigation kernel (:func:`nav_phase`) on the 1M sweep's own
   inputs of its first pass and of a middle pass, and on
   :func:`nav_inputs`' edge bands at 1M rows, each bitwise against the
   plain loop on all eight outputs and timed beside its bound and it;
7. kernel API path (:func:`kernel_api_path`): ``pairwise_dist_op``,
   ``topk_select_op`` and ``bucket_kselect_op`` at the S2 / S3 studies'
   sizes, each bitwise against its kernel's plain version on the card
   (``topk_select`` also against the two-sort merge, with NaN, -inf, -0
   and negative bands, and again on its worst rows, descending and
   one-distance, which are timed too; ``bucket_kselect`` also against its
   guarantee on every row without a NaN distance, and NaN where the plain
   version is) and timed; with them B4's radix select past its warp queue
   (k = 32 at C = 8192 and 40,000; C = 3000, k = 300; C = 8192, k = 512;
   C = 12,000, k = 600; C = 2048, k = 512; NaN, -inf, -0 and negative
   bands), each timed beside ``torch.topk``, and B5's wide routes (the
   staged route at C = 16,384, the wide template at C = 25,000), with and
   without the odd bands;
   then the brute-force baseline ``knn_bruteforce_chunked`` over 128
   queries of the 1M uniform set, on the card bitwise equal to the same
   call on the CPU;
8. single path: a ``KnnSession`` with ``backend="fused_bucket"`` and the
   spec defaults over 1,000,000 uniform objects, one query per object: tick
   0, two ticks where 1% of the objects move up to 200 u, then a snapshot of
   the gaussian (25 hotspots) family at the same N on the stale partition,
   whose drift rebuild runs at its ``result()`` on a clean buffer, an
   unchanged tick, and a uniform snapshot on the gaussian partition with a
   1% move staged while it is in flight, so that its drift rebuild finds
   the move pending.  Every tick
   must launch the kernel, and 1,024 sampled queries per tick must equal a
   brute-force oracle on the card bit for bit.  Two twins are fed the same
   data and must equal the fp32 session's lists on every row, its
   iterations and its candidates on every tick: a ``precision="mixed"``
   twin, which must launch the mixed kernel (and the fp32 session must
   not), and a ``maintenance="incremental"`` twin, which must report
   ``incremental`` on the move ticks, launch B1 as often, hold the same
   index fields after every tick, and take the splice route in the last
   tick's drift rebuild;
9. object-axis paths at the same N, each session beside a ``single`` twin
   fed the same data, whose lists it must equal bit for bit on every row of
   every tick: (a) ``object_sharded``, 4 shards, ``equal``, ``fused_multi``
   over uniform and a 1% move; (b) ``hybrid`` (2, 3), ``cost_balanced``,
   ``fused_merge`` over the gaussian snapshot and a 1% move (the
   object-axis ``skip`` route runs in phase 16's maintenance draw).
   ``fused_multi`` must launch once per tick in (a), ``fused_merge`` twice
   per query shard that owns rows in (b);
10. distributed (:func:`distributed`, :func:`driver_ranks`,
   :func:`server_ranks`): (a) and (b) again, one grid cell per
   ``torch.distributed`` rank (4 and 6 gloo ranks sharing the card, each a
   process of this script with ``--rank-path``, over the same data): every
   rank's lists, per-shard counters, cost EMA, object bounds and rebuild
   decisions must equal phase 9's records bit for bit; on
   every rank of (a) ``fused_multi`` launches once a tick, in (b)
   ``fused_merge`` twice a tick on the ranks whose query shard owns rows;
   then the ``knn`` driver under ``python -m torch.distributed.run
   --nproc-per-node 1`` on NCCL (``--plan hybrid``); then a four-tenant
   ``KnnServer`` on ``object_sharded`` 4 at 12,500 objects (the build, a
   pure-cache tick, a stab, an epoch clear), logically and then one replica
   on each of 4 gloo ranks (``--rank-server``), every rank's tenant rows
   and tick counters equal to the logical server's, and the ``knn`` driver
   with four tenants under ``torch.distributed.run`` on 4 gloo ranks for
   one tick, its ranks' digests equal; a ``distributed`` line per run (each rank's wall,
   gather time, peak and launches);
11. wide sessions (:func:`wide_sessions`): specs that raised on the card
   before the wide templates, each equal to its oracle or twin and
   launching the wide template it exists for; the ``single`` ones at
   N = 200,000, the host-bound object-axis ones (B2 and B3 wide) at
   N = 50,000;
12. incremental object-axis path at N = 50,000
   (:func:`incremental_object_path`): ``object_sharded`` 4 under
   ``maintenance="incremental"``, splicing a 1% move and deferring, by the
   per-shard and the global churn budget, every row equal to a ``single``
   twin;
13. server path at N (:func:`server_path`): a ``KnnServer`` with four
   tenants over the paper's Table 1 world, spatial invalidation: the build,
   an unchanged tick served wholly from the cache (no B1 launch), a
   2,000-object move that recomputes only the stabbed rows, a 1% move that
   clears the epoch; every tenant row equal to a solo session, and a
   ``collect="stats"`` session whose aggregates equal what the full twin's
   lists give, at a peak within 10% of the twin's;
14. the ``knn`` entry point (``repro_torch.launch.serve``) with four
   tenants at N, in this process: it must return 0;
15. evaluation (:func:`evaluation`), the paper's evaluation entry points:
   the ``network``, ``zipf`` and ``hotspot_cluster`` worlds at N through
   ``TickEngine(EngineConfig(backend="fused_bucket")).run(w, ticks=2)``,
   every tick launching B1 with no chunk at ``max_iters`` and 1,024 sampled
   rows equal to the brute-force oracle bit for bit (on the network world
   at least 256 of them objects that sit exactly on a node on tick 1, and
   a ``dense_topk`` twin equal on every row); then
   ``knn_query_batch_chunked`` with ``object_sharded`` 4, ``fused_multi``,
   ``with_aux``, ``equal`` and ``cost_balanced`` on the zipf world at
   200,000 objects, each equal to the ``single`` plan bitwise, with its
   straggler gap; the sequential ``KDTree`` on the host over the network
   world's first tick, held against the card's lists by the reference's
   rule and timed beside it; and the two examples of ``examples_torch/``
   in this process (the service at N, network, ``fused_bucket``), each
   returning 0;
16. properties (:func:`properties`): the reference's property harness
   (``repro_torch.properties``, its draws from ``repro_torch.testing``) on
   the card. Part A at the reference's shapes (96 to 128 objects, k = 6,
   window 16, chunk 16; mesh plans on 4 logical shards, both
   partitioners): the full, mixed and n < k matrices, maintenance and
   server draws, the pinned mover and the R-way composition through B1,
   B1 mixed, B2 and B3, every cell equal to the ``single`` plan's bits and
   each drawn cloud's lists to the oracle; Part B at 1M (two skewed
   clouds with coincident duplicates: fp32, ``mixed`` and ``dense_topk``
   equal on every row, 1,024 rows to the oracle, ``object_sharded`` 4 at
   200,000 equal to ``single``); Part C, the kernel API (B1-B6) on drawn
   shapes against the plain versions;
17. lm (:func:`lm_phase`), the LM harness's serving path, which reaches
   no kernel: ``python -m repro_torch.launch.serve lm --arch rwkv6_3b
   --prompt-len 128 --batch 4 --tokens 16`` at full width and depth, the
   nine other architectures at full width in bf16 (a prefill of 128 and 16
   decode steps, depth cut to ``LM_DEPTHS`` where one card forces it),
   every logit finite; every architecture at full width, cut to one to
   eight layers (``LM_WIDE_DEPTHS``), its bf16 logits equal to its float32
   run's on the card within ``LM_BF16_REL`` (rwkv6: its float32 logits to
   the CPU port's within ``LM_TOL``); then every smoke config in
   float32 on the card equal to the CPU port on the same weights within
   ``LM_TOL``;
18. train (:func:`train_phase`), the LM harness's training side, which
   reaches no kernel: ``python -m repro_torch.launch.train --arch
   rwkv6_3b`` at full width and depth (bf16, ``remat``, batch 8 x 128,
   ``TRAIN_STEPS`` steps), every loss and grad norm finite and every leaf
   that was not constant at the start moved, its peak device memory
   printed; the launcher's crash at step 6 and resume from step 5 (yi_34b
   smoke) against the uninterrupted run; one step per family at smoke
   width in float32 on the card against the CPU port from the same
   weights (gradients, loss, grad norm); the int8 cross-pod step on 2 gloo
   ranks sharing the card against the logical pods in this process, and
   ``launch.train --data 2`` under ``torch.distributed.run`` against the
   one-rank run, within the CPU tests' tolerances;
19. mesh (:func:`mesh_phase`), the LM harness laid over a ``(data,
   model)`` mesh by the rule tables (DTensor; no kernel), on 2 gloo ranks
   sharing the card under one ``torch.distributed.run``: first which
   collectives gloo carries on CUDA tensors; (a) ``launch.train --arch
   yi_34b --layers 2 --dtype float32 --model 2`` at full width against the
   one-rank run (loss and grad-norm curves within ``TRAIN_CURVE_RTOL``,
   every leaf laid on ``model`` split in half on a rank, each rank's
   peak); (b) the same run in bf16 for its seconds a step; (c) ``serve lm
   --arch qwen3_moe_235b_a22b --model 2`` against one rank: cut to 2
   layers in float32, the greedy tokens wherever one rank's top two
   logits are more than ``MESH_F32_TOL`` apart; cut to 4 layers in bf16,
   ms/token, tok/s and each rank's peak, the tokens counted against
   ``MESH_BF16_TOL``; (d)
   ``python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k``
   on the host (a fake process group of 256 ranks, no device), beside
   them; (e) the int8 cross-pod step laid on ``model``
   (:func:`mesh_xpod`): h2o_danube_3_4b at full width cut to 2 layers,
   float32, on a (2, 1, 2) mesh of 4 gloo ranks, each pod's state laid
   on its (1, 2) mesh, against the same steps on (2, 1, 1) (2 ranks, run
   after it): loss and grad norm within ``XPOD_RTOL``, the error feedback
   within one of pod 0's scales an element, every leaf moved, each
   rank's leaves on ``model`` halved.

Launch counts are zeroed just before each path (each tick, in the single
and server paths) and read just after, on the path's own session only.  The
next-to-last line is the kernels' JSON record, narrow and wide templates;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def fma_exact(a, b, c):
    """Correctly rounded f32 fma: f64 product (exact) + round-to-odd sum."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # exact: s + err == p + cd
    toward0 = (err != 0) & ((err > 0) != (s > 0))
    si = s.view(torch.int64)
    si = torch.where(toward0, si - 1, si)
    si = torch.where(err != 0, si | 1, si)
    return si.view(torch.float64).float()


def check_fma(dev):
    g = np.random.default_rng(1)
    a, b = (torch.tensor(g.uniform(-2e3, 2e3, 1 << 22), dtype=torch.float32,
                         device=dev) for _ in range(2))
    c = torch.tensor(g.uniform(0, 1e6, 1 << 22), dtype=torch.float32,
                     device=dev)
    from repro_torch.runtime import fma

    if not torch.equal(fma(a, b, c), fma_exact(a, b, c)):
        raise AssertionError("torch.addcmul is not a fused multiply-add here")
    print("fma: torch.addcmul == exact fma on 4,194,304 samples")


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device milliseconds of one call of ``fn``: ``inner`` calls captured
    in a CUDA graph, the graph replayed ``reps`` times, so that a kernel
    shorter than its wrapper's Python is not timed at the host's launch
    rate."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps=reps) / inner


def edge_lists(n_rows: int, k: int, seed: int = 0) -> np.ndarray:
    """(n_rows, k) ascending full lists whose last bucket edge of the first
    refinement round, ``fma(31, width, lo)``, is itself a list entry that the
    division ``(x - lo) / width`` bins one bucket lower.  Merged with an
    empty window, the reference's fused kernel loses the k-th entry of every
    such row (its histogram rank counts the edge entry below the bucket)."""
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.runtime import fma

    g = np.random.default_rng(seed)
    t = lambda v: torch.tensor([v], dtype=torch.float32)
    rows = []
    while len(rows) < n_rows:
        lo = np.float32(g.uniform(1, 1000))
        hi0 = np.float32(lo + g.uniform(100, 6000))
        width = (fma(t(hi0), t(fs.HI_MUL), t(fs.HI_ADD)) - t(lo)) / 32
        x = fma(t(31.0), width, t(lo))
        if torch.floor((x - t(lo)) / width).item() != 30 or x.item() >= hi0:
            continue
        x = np.float32(x.item())
        row = np.concatenate([
            [lo], np.sort(g.uniform(lo, x, k - 5)), [x],
            np.sort(g.uniform(x, hi0, 2)), [hi0]]).astype(np.float32)
        if np.all(np.diff(row) > 0):
            rows.append(row)
    return np.stack(rows)


def kernel_inputs(q: int, w: int, k: int, dev, seed: int = 0,
                  odd: bool = True):
    """Main-path shapes with edge rows, in bands of q // 16 rows: coincident
    points, distance ties, all-invalid rows, rows with fewer than k valid
    entries, full lists merged with an empty window whose k-th entry sits in
    the bucket of an edge entry (:func:`edge_lists`); then partly filled and
    full current lists.  With ``odd`` (see :func:`odd_rows`) also: lists out
    of order with their largest entry last, lists in any order, a NaN
    window distance with n_valid >= k and with n_valid < k, a NaN list
    entry, and lists with negative entries, -inf and -0.  Made on ``dev``
    from ``seed`` (a generator of that device)."""
    from repro_torch.kernels.fused_scan import fused_scan_merge_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
    normal = lambda *shape: torch.randn(shape, generator=g, device=dev)
    ids = lambda *shape: torch.randint(0, 1 << 30, shape, generator=g,
                                       device=dev, dtype=torch.int32)
    qx, qy = rand(q) * 22_500, rand(q) * 22_500
    cx = qx[:, None] + normal(q, w) * 300
    cy = qy[:, None] + normal(q, w) * 300
    cids = ids(q, w)
    valid = rand(q, w) < 0.9
    e = q // 16  # edge-row band height
    # coincident points: d2 == 0
    cx[:e, ::7] = qx[:e, None]
    cy[:e, ::7] = qy[:e, None]
    # equal distances, distinct ids: mirrored integer offsets
    off = torch.randint(1, 4, (e, w), generator=g, device=dev).float()
    sign = torch.where(rand(e, w) < 0.5, -1.0, 1.0)
    cx[e:2 * e] = qx[e:2 * e, None] + sign * off
    cy[e:2 * e] = qy[e:2 * e, None]
    valid[2 * e:3 * e] = False  # all invalid
    valid[3 * e:4 * e] = False
    valid[3 * e:4 * e, :5] = True  # n_valid < k
    inf_d = torch.full((q, k), float("inf"), device=dev)
    neg_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    # current lists: a first merge of another window, then cut some short
    px = qx[:, None] + normal(q, w) * 300
    py = qy[:, None] + normal(q, w) * 300
    full_d, full_i = fused_scan_merge_ref(qx, qy, px, py, ids(q, w),
                                          rand(q, w) < 0.9, inf_d, neg_i, k=k)
    del px, py
    keep = torch.randint(0, k + 1, (q,), generator=g, device=dev)
    cut = torch.arange(k, device=dev)[None, :] >= keep[:, None]
    cut[:4 * e] = True  # the edge bands start from empty lists
    bd = torch.where(cut, float("inf"), full_d).contiguous()
    bi = torch.where(cut, -1, full_i).to(torch.int32).contiguous()
    if k >= 5 and e:  # full lists on a bucket edge, with an empty window
        valid[4 * e:5 * e] = False
        bd[4 * e:5 * e] = torch.tensor(edge_lists(e, k, seed), device=dev)
        bi[4 * e:5 * e] = torch.arange(e * k, device=dev,
                                       dtype=torch.int32).view(e, k)
    if odd:
        # lists out of order: the largest entry stays last, then any order
        for band, cols in ((5, k - 1), (6, k)):
            rows = slice(band * e, (band + 1) * e)
            perm = torch.argsort(rand(e, k)[:, :cols], dim=1)
            bd[rows] = full_d[rows]
            bi[rows] = full_i[rows]
            bd[rows, :cols] = torch.gather(full_d[rows, :cols], 1, perm)
            bi[rows, :cols] = torch.gather(full_i[rows, :cols], 1, perm)
        nan = float("nan")
        rows = slice(7 * e, 8 * e)  # a NaN distance, n_valid >= k
        bd[rows], bi[rows] = full_d[rows], full_i[rows]
        valid[rows, 3] = True
        cx[rows, 3] = nan
        rows = slice(8 * e, 9 * e)  # a NaN distance, n_valid < k
        bd[rows], bi[rows] = inf_d[rows], neg_i[rows]
        valid[rows] = False
        valid[rows, :5] = True
        cy[rows, 2] = nan
        rows = slice(9 * e, 10 * e)  # a NaN list entry
        bd[rows], bi[rows] = full_d[rows], full_i[rows]
        bd[rows, k // 2] = nan
        rows = slice(10 * e, 11 * e)  # negative entries, -inf and -0
        bd[rows] = full_d[rows] - 2.0e4  # about the lists' 0.7 quantile
        bi[rows] = full_i[rows]
        bd[10 * e:11 * e:2, 0] = -float("inf")
        if k >= 2:
            bd[rows, 1] = -0.0
    return (qx.contiguous(), qy.contiguous(), cx.contiguous(),
            cy.contiguous(), cids, valid, bd.contiguous(), bi.contiguous())


def odd_rows(q: int, dev, mixed: bool = False) -> torch.Tensor:
    """(q,) mask of :func:`kernel_inputs`' rows outside a premise: the NaN
    and negative bands, where the fused merge is not the exact k-selection
    of ``list ++ window d2`` (a NaN makes the reference's radius NaN, and a
    negative value breaks the refinement's interval); with ``mixed`` also
    the lists in any order, where ``best_d[:, k-1]`` is not the list's
    largest entry and the mixed prefilter's premise fails (so
    ``precision="mixed"`` need not equal fp32 there, as in the
    reference)."""
    e = q // 16
    rows = torch.zeros(q, dtype=torch.bool, device=dev)
    rows[(6 if mixed else 7) * e:11 * e] = True
    return rows


def odd_values(d: torch.Tensor) -> torch.Tensor:
    """A copy of the (Q, C) distances with bands of q // 16 rows from the
    tenth on: a NaN in column 0 (even rows) or in column C // 2 (odd rows),
    a -inf and a -0, and negative entries.  Inputs for the wide templates,
    which take such rows as the plain version does (``masked_argmin_rounds``
    emits (NaN, INT_MAX) while a NaN is left)."""
    d = d.clone()
    q, c = d.shape
    e = max(1, q // 16)
    nan = float("nan")
    d[10 * e:11 * e:2, 0] = nan
    d[10 * e + 1:11 * e:2, c // 2] = nan
    d[11 * e:12 * e, c // 3] = -float("inf")
    d[11 * e:12 * e, c // 4] = -0.0
    d[12 * e:13 * e] -= 2.0e6
    return d.contiguous()


def merge_inputs(r: int, q: int, k: int, dev, seed: int = 0,
                 inf_ids: bool = False):
    """(R, Q, k) per-shard lists as the object-axis plans give them, each
    ascending by (d2, id) and (inf, -1) padded, with edge bands of rows:
    equal distances across lists with distinct ids; one list empty; partly
    filled lists; every list of the row empty; runs of equal distances
    inside a list; exact (d2, id) duplicates across lists (the column
    decides their order); partly filled lists, padded with (inf, id) for
    ids other than -1 where ``inf_ids`` (a list that is still ascending for
    the merge kernels, though no plan pads so)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.rand((r, q, k), generator=g, device=dev) * 4.0e6
    ids = torch.randint(0, 1 << 30, (r, q, k), generator=g, device=dev,
                        dtype=torch.int32)
    e = max(1, q // 16)  # edge-band height
    d[:, :e] = d[:1, :e]  # ties across lists
    d[:, 4 * e:5 * e] = torch.floor(d[:, 4 * e:5 * e] / 5.0e5) * 5.0e5
    d[:, 5 * e:6 * e] = d[:1, 5 * e:6 * e]  # the same pairs in every list
    ids[:, 5 * e:6 * e] = ids[:1, 5 * e:6 * e]
    by_id = torch.sort(ids, dim=2, stable=True).indices
    d, ids = torch.gather(d, 2, by_id), torch.gather(ids, 2, by_id)
    d, by_d = torch.sort(d, dim=2, stable=True)
    ids = torch.gather(ids, 2, by_d)
    col = torch.arange(k, device=dev)
    fill = torch.randint(0, k + 1, (r, q), generator=g, device=dev)
    empty = torch.zeros((r, q, k), dtype=torch.bool, device=dev)
    empty[0, e:2 * e] = True  # one list empty
    empty[:, 2 * e:3 * e] = (col >= fill[:, 2 * e:3 * e, None])
    empty[:, 3 * e:4 * e] = True  # every list empty
    empty[:, 6 * e:7 * e] = (col >= fill[:, 6 * e:7 * e, None])
    keep_id = torch.zeros_like(empty)
    keep_id[:, 6 * e:7 * e] = inf_ids  # (inf, id) padding
    d = torch.where(empty, float("inf"), d)
    ids = torch.where(empty & ~keep_id, -1, ids).to(torch.int32)
    return d.contiguous(), ids.contiguous()


def topk_inputs(q: int, c: int, k: int, dev, seed: int = 0):
    """(Q, C) distances and i32 ids for ``topk_select``, with edge bands of
    rows: distances on a coarse grid (ties across distinct ids), bf16-rounded
    distances, +inf entries, fewer than k finite entries, every entry +inf,
    exact (d2, id) duplicates, rows in descending order (every entry enters
    a warp-queue select), one d2 for the whole row with descending ids, each
    32-column slab a copy of the first (duplicates in other slabs), and
    zeros of both signs (equal distances: the lower id goes first)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.rand((q, c), generator=g, device=dev) * 4.0e6
    ids = torch.randint(0, 1 << 30, (q, c), generator=g, device=dev,
                        dtype=torch.int32)
    e = max(1, q // 16)  # edge-band height
    inf = float("inf")
    d[:e] = torch.floor(d[:e] / 2.0e5) * 2.0e5  # ties across ids
    d[e:2 * e] = d[e:2 * e].to(torch.bfloat16).to(torch.float32)
    d[2 * e:3 * e, ::3] = inf  # +inf entries
    d[3 * e:4 * e, max(1, min(k, c) // 2):] = inf  # fewer than k finite
    d[4 * e:5 * e] = inf  # nothing finite
    d[5 * e:6 * e] = torch.floor(d[5 * e:6 * e] / 1.0e6) * 1.0e6
    ids[5 * e:6 * e] = ids[5 * e:6 * e] % 4  # exact (d2, id) duplicates
    d[6 * e:7 * e] = torch.sort(d[6 * e:7 * e], dim=1, descending=True).values
    d[7 * e:8 * e] = d[7 * e:8 * e, :1]  # one d2, ids descending
    ids[7 * e:8 * e] = torch.arange(c, 0, -1, device=dev, dtype=torch.int32)
    slab = torch.arange(c, device=dev) % 32  # every slab repeats the first
    d[8 * e:9 * e] = d[8 * e:9 * e, slab]
    ids[8 * e:9 * e] = ids[8 * e:9 * e, slab]
    d[9 * e:10 * e, ::2] = -0.0  # signed zeros, random ids
    d[9 * e:10 * e, 1::4] = 0.0
    return d.contiguous(), ids.contiguous()


def worst_rows(q: int, c: int, kind: str, dev, seed: int = 0):
    """(Q, C) rows on which every entry enters a warp-queue select:
    ``descending`` (random distances sorted descending, random ids) or
    ``equal`` (one distance for the whole row, ids descending)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "descending":
        d = torch.rand((q, c), generator=g, device=dev) * 4.0e6
        d = torch.sort(d, dim=1, descending=True).values
        ids = torch.randint(0, 1 << 30, (q, c), generator=g, device=dev,
                            dtype=torch.int32)
    elif kind == "equal":
        d = (torch.rand((q, 1), generator=g, device=dev) * 4.0e6).expand(q, c)
        ids = torch.arange(c, 0, -1, device=dev,
                           dtype=torch.int32).expand(q, c)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return d.contiguous(), ids.contiguous()


def window_inputs(q: int, c: int, dev, seed: int = 0, side: float = 22_500.0,
                  invalid: float = 0.1, coincide: int = 40, odd: bool = True):
    """(Q, 2) uniform queries and one shared (C, 2) uniform candidate window
    over the spec's region, a fraction ``invalid`` of the window invalid and
    its first ``coincide`` points on one spot (equal distances).  With
    ``odd``: the second band of q // 16 queries has a NaN coordinate (every
    valid distance of those rows is NaN), the third lies at negative
    coordinates, and the window's last point has NaN coordinates and is
    invalid (its distance must stay +inf)."""
    g = np.random.default_rng(seed)
    qpos = g.uniform(0, side, (q, 2)).astype(np.float32)
    ppos = g.uniform(0, side, (c, 2)).astype(np.float32)
    ppos[1:coincide] = ppos[0]
    valid = g.random(c) >= invalid
    if odd:
        e = q // 16
        qpos[e:2 * e, 0] = np.nan
        qpos[2 * e:3 * e] *= -1
        if c > 1:
            ppos[-1] = np.nan
            valid[-1] = False
    return (torch.tensor(qpos, device=dev), torch.tensor(ppos, device=dev),
            torch.tensor(valid, device=dev))


def nav_index(family: str, n: int, l_max: int, dev, seed: int = 0,
              side: float = 22_500.0, th_quad: int = 16,
              origin=(0.0, 0.0), partition: str | None = None):
    """The quadtree over ``n`` objects of a workload family on ``dev``: a
    clustered family leaves empty leaves beside full ones at ``l_max``.
    With ``partition``, the leaf levels are those of that family's world
    (a stale partition, as between drift rebuilds): blocks above a leaf
    may then be empty."""
    import dataclasses

    from repro_torch.core.quadtree import build_index
    from repro_torch.data import make_workload

    def build(fam):
        pts = make_workload(n, fam, seed=seed, side=side).positions()
        pts = pts.astype(np.float32) + np.float32(origin)
        return build_index(torch.tensor(pts, device=dev), origin, side,
                           l_max=l_max, th_quad=th_quad)

    index = build(family)
    if partition is not None:
        index = dataclasses.replace(index,
                                    leaf_level=build(partition).leaf_level)
    return index


NAV_BANDS = 16


def nav_inputs(index, n: int, dev, seed: int = 0):
    """``nav_walk``'s ten row inputs for ``n`` rows (a multiple of
    :data:`NAV_BANDS`) against ``index``: qx, qy, kth2, cl, cr, act_l,
    act_r, next_right, s, e.

    Bands of n // 16 rows: 0 as the sweep leaves them (cursors at a leaf's
    two ends, both directions active, k-th distances from a fine cell's
    width to the domain's); 1 the same, going right, with kth2 exactly the
    squared distance to the leaf right of the cursor (a tie, which `<=`
    scans); 2 cursors anywhere in [0, 4^l_max]; 3 cl = 0;
    4 cr = 4^l_max; 5 both; 6 the left side inactive; 7 the right side; 8
    both (already done); 9 kth2 = inf (the first leaf with objects is
    found); 10 kth2 = 0; 11 kth2 NaN; 12 qx NaN; 13 qx -inf and qy +inf;
    14 queries outside the domain; 15 cursors on aligned block boundaries
    of every level, half of them cr = 0 and cl = 4^l_max (a quarter with
    the query a side's length left of the domain)."""
    if n % NAV_BANDS:
        raise ValueError(f"nav_inputs: {n} rows is not a multiple of "
                         f"{NAV_BANDS}")
    g = np.random.default_rng(seed)
    l_max = index.l_max
    n_fine = 4**l_max
    side = float(index.side)
    ox, oy = index.origin.tolist()
    leaf_level = index.leaf_level.cpu().numpy()
    qx = (ox + g.uniform(0, side, n)).astype(np.float32)
    qy = (oy + g.uniform(0, side, n)).astype(np.float32)
    kth = 10 ** g.uniform(np.log10(side / 2**l_max / 4), np.log10(side), n)
    kth2 = np.square(kth.astype(np.float32))
    fine = g.integers(0, n_fine, n)
    shift = 2 * (l_max - leaf_level[fine].astype(np.int64))
    cl = (fine >> shift) << shift
    cr = cl + (1 << shift)
    act_l = np.ones(n, bool)
    act_r = np.ones(n, bool)
    next_right = g.random(n) < 0.5
    n_obj = index.n_objects
    s = g.integers(0, n_obj + 1, n)
    e = g.integers(0, n_obj + 1, n)
    b = n // NAV_BANDS
    band = lambda i: slice(i * b, (i + 1) * b)
    cl[band(2)] = g.integers(0, n_fine + 1, b)
    cr[band(2)] = g.integers(0, n_fine + 1, b)
    cl[band(3)] = 0
    cr[band(4)] = n_fine
    cl[band(5)] = 0
    cr[band(5)] = n_fine
    act_l[band(6)] = False
    act_r[band(7)] = False
    act_l[band(8)] = act_r[band(8)] = False
    kth2[band(9)] = np.inf
    kth2[band(10)] = 0.0
    kth2[band(11)] = np.nan
    qx[band(12)] = np.nan
    qx[band(13)] = -np.inf
    qy[band(13)] = np.inf
    qx[band(14)] = ox + g.uniform(-side, 2 * side, b)
    qy[band(14)] = oy + np.where(g.random(b) < 0.5, -1.0, 2.0) * g.uniform(
        side, 2 * side, b)
    a = g.integers(0, l_max + 1, (2, b))
    cl[band(15)] = g.integers(0, (n_fine >> (2 * a[0])) + 1) << (2 * a[0])
    cr[band(15)] = g.integers(0, (n_fine >> (2 * a[1])) + 1) << (2 * a[1])
    cr[15 * b:15 * b + b // 2] = 0
    cl[15 * b:15 * b + b // 2] = n_fine
    qx[15 * b:15 * b + b // 4] = ox - side  # the whole domain may be far
    next_right[band(1)] = True
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    flag = lambda v: torch.tensor(v, dtype=torch.bool, device=dev)
    rows = [f32(qx), f32(qy), f32(kth2), i32(cl), i32(cr), flag(act_l),
            flag(act_r), flag(next_right), i32(s), i32(e)]
    from repro_torch.core.morton import point_to_block_dist2

    key = rows[4][band(1)].clamp(0, n_fine - 1)
    rows[2][band(1)] = point_to_block_dist2(
        rows[0][band(1)], rows[1][band(1)], key,
        l_max - index.leaf_level[key], index.origin, index.side, l_max)
    return tuple(rows)


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal`` with NaN equal to NaN: equal shapes and types, and
    per element the same value (so -0 equals +0, as ``torch.equal`` has
    it) or NaN in both (a NaN's payload is not part of any kernel's
    contract)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def edge_window(k: int, seed: int = 0):
    """A (1, 2) query at the origin and a (k, 2) window on the x axis whose
    sorted distances have :func:`edge_lists`' shape: the first refinement
    round's last bucket edge, ``fma(31, width, lo)``, is itself a distance
    that the division bins one bucket lower.  With k = C the reference's
    ``bucket_kselect`` and ``find_kdist`` track the wrong rank here, and
    their radius leaves the k-th distance outside (numpy, float32)."""
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.runtime import fma

    g = np.random.default_rng(seed)
    t = lambda v: torch.tensor([v], dtype=torch.float32)

    def sq(x):  # the kernels' d2 of an x-axis point: fma(x, x, 0)
        return np.float32(x) * np.float32(x)

    def root_of(d):  # an f32 x with sq(x) == d, or None
        r = np.float32(np.sqrt(np.float64(d)))
        for x in (r, np.nextafter(r, np.float32(0)),
                  np.nextafter(r, np.float32(np.inf))):
            if sq(x) == d:
                return np.float32(x)
        return None

    while True:
        x_lo = np.float32(g.uniform(1, 30))
        x_hi = np.float32(x_lo + g.uniform(10, 80))
        lo, hi0 = sq(x_lo), sq(x_hi)
        width = (fma(t(hi0), t(fs.HI_MUL), t(fs.HI_ADD)) - t(lo)) / 32
        edge = fma(t(31.0), width, t(lo))
        if torch.floor((edge - t(lo)) / width).item() != 30:
            continue
        x_edge = root_of(np.float32(edge.item()))
        if x_edge is None or not x_lo < x_edge < x_hi:
            continue
        xs = np.concatenate([
            [x_lo], np.sort(g.uniform(x_lo, x_edge, k - 5)), [x_edge],
            np.sort(g.uniform(x_edge, x_hi, 2)), [x_hi]]).astype(np.float32)
        if np.all(np.diff(sq(xs)) > 0):
            ppos = np.stack([xs, np.zeros_like(xs)], 1)
            return np.zeros((1, 2), np.float32), ppos


def _record(name, source, replaces, launches, ms, plain_ms, nbytes, ops,
            library_ms, max_abs_err=0.0, **extra):
    """One kernel's record; the bound is the larger of ``nbytes`` over the
    memory rate and ``ops`` over the f32 rate.  ``launches`` None is filled
    in from the kernel's path."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict({
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "bitwise": True}, **extra)


def _in_blocks(fn, args, blk: int = 65536):
    """``fn`` over row blocks of every argument, outputs concatenated: a
    plain version at 1M rows without its temporaries at 1M rows."""
    outs = [fn(*(a[r:r + blk] for a in args))
            for r in range(0, args[0].shape[0], blk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _check_lists(what, out, want, rows=None):
    """(d, i) lists equal bit for bit (on ``rows`` where given)."""
    if rows is not None:
        out = (out[0][rows], out[1][rows])
        want = (want[0][rows], want[1][rows])
    if not (same_values(out[0], want[0]) and torch.equal(out[1], want[1])):
        bad = ((out[0] != want[0]) | (out[1] != want[1])).any(1)
        raise AssertionError(f"{what} on {int(bad.sum())} rows, e.g. "
                             f"{bad.nonzero()[:8, 0].tolist()}")


def kernel_phase(dev, q=8192, w=256, k=32):
    """B1, fp32 and mixed, at (Q, W, k) on :func:`kernel_inputs`' rows:
    bitwise against the plain versions (in row blocks) on every row, the
    NaN and negative bands included; against the exact two-sort merge, and
    mixed against fp32, on the rows inside their premise (:func:`odd_rows`);
    then timed on the rows without the odd bands (``ms``) and with them
    (``odd_rows_ms``), beside the plain version and the two-sort merge."""
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels.ops import _lex_sort_merge
    from repro_torch.kernels.refine import mixed_prune_keep

    fp32, mixed = dict(k=k), dict(k=k, precision="mixed")
    run = lambda a, kw: fs.fused_scan_merge(*a, **kw)
    plain = lambda a, kw: _in_blocks(
        lambda *b: fs.fused_scan_merge_ref(*b, **kw), a)

    def two_sort(a, precision="fp32"):
        return _lex_sort_merge(torch.stack([a[0], a[1]], 1),
                               torch.stack([a[2], a[3]], 2), *a[4:], k,
                               precision=precision)

    args = kernel_inputs(q, w, k, dev)
    fs.fused_scan_merge.launches = fs.fused_scan_merge.mixed_launches = 0
    out, out_m = run(args, fp32), run(args, mixed)
    torch.cuda.synchronize()
    if (fs.fused_scan_merge.launches, fs.fused_scan_merge.mixed_launches) \
            != (1, 1):
        raise AssertionError("fused_scan_merge did not launch its kernels")
    ref, ref_m = plain(args, fp32), plain(args, mixed)
    _check_lists("kernel != plain version", out, ref)
    _check_lists("mixed kernel != plain mixed version", out_m, ref_m)
    _check_lists("kernel != exact two-sort merge",
                 out, _in_blocks(lambda *b: two_sort(b), args),
                 ~odd_rows(q, dev))
    _check_lists("mixed kernel != fp32 kernel", out_m, out,
                 ~odd_rows(q, dev, mixed=True))
    # the plain version on the card equals it on the CPU (held against JAX
    # by the CPU tests), on 512 rows across every band
    rows = torch.arange(0, q, max(1, q // 512), device=dev)
    for kw, want in ((fp32, ref), (mixed, ref_m)):
        cpu = fs.fused_scan_merge_ref(*(a[rows].cpu() for a in args), **kw)
        _check_lists("plain version differs between card and CPU", cpu,
                     (want[0][rows].cpu(), want[1][rows].cpu()))
    fin = torch.isfinite(ref[0])
    max_abs_err = float((out[0][fin] - ref[0][fin]).abs().max()) \
        if fin.any() else 0.0
    del out, out_m, ref, ref_m

    # timed on the rows without the odd bands, checked there too
    base = kernel_inputs(q, w, k, dev, odd=False)
    # under 65,536 rows the kernel is shorter than the wrapper's Python:
    # timed in CUDA graphs
    small = q <= 65536
    timed = (lambda fn: time_graph_ms(fn)) if small else (
        lambda fn: time_ms(fn, reps=5))
    recs = []
    for name, kw, line in (("fused_scan_merge", fp32, 126),
                           ("fused_scan_merge_mixed", mixed, 52)):
        _check_lists(f"{name} != plain version (base rows)", run(base, kw),
                     plain(base, kw))
        ms = timed(lambda: run(base, kw))
        odd_ms = timed(lambda: run(args, kw))
        plain_ms = time_ms(lambda: plain(base, kw), reps=3 if small else 1,
                           warmup=1)
        library_ms = time_ms(lambda: two_sort(base, kw.get("precision",
                                                          "fp32")),
                             reps=10 if small else 3, warmup=1)
        # bound: each input read once, each output written once; a distance
        # (6 flops) a window entry and one compare an entry of the row
        nbytes = q * (8 + 13 * w + 8 * k) + q * 8 * k
        ops = q * (6 * w + (k + w))
        extra = {}
        if kw is mixed:
            keep = mixed_prune_keep(base[2] - base[0][:, None],
                                    base[3] - base[1][:, None],
                                    base[6][:, k - 1])
            extra["pruned_share"] = float((base[5] & ~keep).sum()) / max(
                1, int(base[5].sum()))
            ops += q * w * 6  # the prefilter
            del keep
        rec = _record(name, "fused_scan.cu",
                      f"src/repro/kernels/fused_scan.py:{line}", None, ms,
                      plain_ms, nbytes, ops, library_ms, max_abs_err,
                      shape=f"Q={q} W={w} k={k}", odd_rows_ms=odd_ms,
                      timing="cuda graph" if small else "launches", **extra)
        print(f"kernel: {name} Q={q} W={w} k={k} bitwise equal to its plain "
              f"version on every row (NaN and negative bands included), to "
              f"the exact merge and mixed to fp32 inside their premise; "
              f"{ms:.4f} ms ({odd_ms:.4f} ms with the odd bands; plain "
              f"{plain_ms:.3f} ms, two-sort {library_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
        recs.append(rec)
    return recs


def _check_merge(name, out, plain, two_sort):
    """The kernel's (d, i) lists bitwise equal to its plain version and to
    the two-sort merge; returns the largest distance error (0)."""
    for what, want in (("plain version", plain), ("two-sort merge", two_sort)):
        if not (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])):
            bad = ((out[0] != want[0]) | (out[1] != want[1])).any(1)
            raise AssertionError(
                f"{name} != {what} on {int(bad.sum())} rows, e.g. "
                f"{bad.nonzero()[:8, 0].tolist()}")
    fin = torch.isfinite(plain[0])
    return float((out[0][fin] - plain[0][fin]).abs().max()) if fin.any() \
        else 0.0


def _merge_record(name, source_line, q, row, k, out, plain, two_sort,
                  run_kernel, run_plain, run_two_sort, reps):
    """Bitwise checks and times of one merge kernel; row = input columns."""
    max_abs_err = _check_merge(name, out, plain, two_sort)
    ms = time_ms(run_kernel, reps=reps)
    plain_ms = time_ms(run_plain, reps=3, warmup=1)
    library_ms = time_ms(run_two_sort, reps=5, warmup=1)
    # bound: each input read once, each output written once; the k smallest
    # of sorted lists need one comparison per entry read and per output
    nbytes = q * row * 8 + q * k * 8
    ops = q * (row + k)
    rec = _record(name, "merge_topk.cu",
                  f"src/repro/kernels/merge_topk.py:{source_line}", None, ms,
                  plain_ms, nbytes, ops, library_ms, max_abs_err)
    print(f"kernel: {name} Q={q} row={row} k={k} bitwise equal to the plain "
          f"version and the two-sort merge; {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, two-sort {library_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}: {nbytes} bytes, "
          f"{ops} ops)")
    return rec


def merge_kernel_phase(dev, q_multi=1_007_616, q_lists=503_808, k=32):
    """B2 and B3 on the card at the object-axis paths' shapes."""
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels.ops import topk_select_ref

    r = 4
    d, i = merge_inputs(r, q_multi, k, dev, seed=5, inf_ids=True)
    d_cat = d.transpose(0, 1).reshape(q_multi, r * k).contiguous()
    i_cat = i.transpose(0, 1).reshape(q_multi, r * k).contiguous()
    del d, i
    mt.merge_topk_multi.launches = 0
    out = mt.merge_topk_multi(d_cat, i_cat, k=k)
    torch.cuda.synchronize()
    if mt.merge_topk_multi.launches != 1:
        raise AssertionError("merge_topk_multi did not launch its kernel")
    rec_multi = _merge_record(
        "merge_topk_multi", 75, q_multi, r * k, k, out,
        mt.merge_topk_multi_ref(d_cat, i_cat, k=k),
        topk_select_ref(d_cat, i_cat, k),
        lambda: mt.merge_topk_multi(d_cat, i_cat, k=k),
        lambda: mt.merge_topk_multi_ref(d_cat, i_cat, k=k),
        lambda: topk_select_ref(d_cat, i_cat, k), reps=20)
    del d_cat, i_cat, out

    d, i = merge_inputs(2, q_lists, k, dev, seed=6, inf_ids=True)
    rec_lists = None
    for ka in (20, k):  # a narrower list, then the path's shape (timed)
        args = (d[0, :, :ka].contiguous(), i[0, :, :ka].contiguous(),
                d[1].contiguous(), i[1].contiguous())
        cat = (torch.cat([args[0], args[2]], 1), torch.cat([args[1], args[3]],
                                                             1))
        mt.merge_topk_lists.launches = 0
        out = mt.merge_topk_lists(*args, k=k)
        torch.cuda.synchronize()
        if mt.merge_topk_lists.launches != 1:
            raise AssertionError("merge_topk_lists did not launch its kernel")
        plain = mt.merge_topk_lists_ref(*args, k=k)
        two_sort = topk_select_ref(*cat, k)
        if ka != k:
            _check_merge("merge_topk_lists", out, plain, two_sort)
            print(f"kernel: merge_topk_lists Q={q_lists} ka={ka} kb={k} k={k} "
                  "bitwise equal to the plain version and the two-sort merge")
            continue
        rec_lists = _merge_record(
            "merge_topk_lists", 119, q_lists, 2 * k, k, out, plain, two_sort,
            lambda: mt.merge_topk_lists(*args, k=k),
            lambda: mt.merge_topk_lists_ref(*args, k=k),
            lambda: topk_select_ref(*cat, k), reps=20)
    return rec_multi, rec_lists


def wide_kernel_phase(dev, q_b1=8192, q_merge=65536):
    """The wide routes of B1 (fp32 and mixed), B2 and B3, past the narrow
    templates' 512-entry rows: each launched once (its wide and route
    counters read), held bitwise against its plain version on every row,
    and timed beside its bound, the plain version and the two-sort merge,
    on the rows without the odd bands (``ms``) and with them
    (``odd_rows_ms``).
    - B1 at Q = ``q_b1`` on :func:`kernel_inputs`' rows (edge, NaN,
      negative and unsorted bands) at W = 1024, k = 32 (the wide queue)
      and W = 256, k = 512 and 384 (the wide merge; k = 384 is the hybrid
      session's row), in CUDA graphs;
    - B2 at R = 8, k = 128 (``object_sharded`` 8's merge) and B3 at
      ka = kb = k = 384 (``fused_merge`` at k = 384), both the wide merge,
      Q = ``q_merge``, on :func:`merge_inputs`' edge rows with
      :func:`odd_values`' NaN, -inf, -0 and negative bands and one list
      out of order in one band (B2's fourth, B3's first).
    Returns the records by name (``launches`` filled in from the wide
    sessions; B1 mixed at k = 384 is an ``other_shapes`` entry of the
    k = 512 record, as no mixed session runs that row)."""
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels.ops import _lex_sort_merge, topk_select_ref

    recs = {}
    for w, k in ((1024, 32), (256, 512), (256, 384)):
        args = kernel_inputs(q_b1, w, k, dev, seed=w + k)
        base = kernel_inputs(q_b1, w, k, dev, seed=w + k, odd=False)
        route = "wide_queue" if k <= 256 else "wide_merge"
        for prefix, precision, line in (("fused_scan_merge", "fp32", 126),
                                        ("fused_scan_merge_mixed", "mixed",
                                         52)):
            kw = dict(k=k, precision=precision)
            name = f"{prefix}_wide_w{w}_k{k}"
            fn = fs.fused_scan_merge
            fn.wide_launches = 0
            setattr(fn, f"{route}_launches", 0)
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            if (fn.wide_launches, getattr(fn, f"{route}_launches")) != (1, 1):
                raise AssertionError(f"{name}: the {route} route did not run")
            ref = fs.fused_scan_merge_ref(*args, **kw)
            _check_lists(f"{name} != plain version", out, ref)
            _check_lists(f"{name} != plain version (base rows)",
                         fn(*base, **kw), fs.fused_scan_merge_ref(*base, **kw))
            fin = torch.isfinite(ref[0])
            err = float((out[0][fin] - ref[0][fin]).abs().max())
            ms = time_graph_ms(lambda: fn(*base, **kw))
            odd_ms = time_graph_ms(lambda: fn(*args, **kw))
            plain_ms = time_ms(lambda: fs.fused_scan_merge_ref(*base, **kw),
                               reps=1, warmup=1)
            library_ms = time_ms(lambda: _lex_sort_merge(
                torch.stack(base[:2], 1), torch.stack(base[2:4], 2),
                *base[4:], k, precision=precision), reps=3, warmup=1)
            nbytes = q_b1 * (8 + 13 * w + 8 * k) + q_b1 * 8 * k
            ops = q_b1 * (6 * w + (k + w))
            if precision == "mixed":
                ops += q_b1 * w * 6  # the prefilter
            rec = _record(
                name, "fused_scan.cu", f"src/repro/kernels/fused_scan.py:{line}",
                None, ms, plain_ms, nbytes, ops, library_ms, err,
                shape=f"Q={q_b1} W={w} k={k}", template="wide",
                wide_route=route, odd_rows_ms=odd_ms, timing="cuda graph")
            key = (f"{prefix}_wide_w256_k512"
                   if precision == "mixed" and k == 384 else name)
            _add_shape(recs, key, rec)
            print(f"kernel: {name} Q={q_b1} W={w} k={k} ({route} route) "
                  f"bitwise equal to its plain version on every row (NaN, "
                  f"negative and unsorted bands included); {ms:.4f} ms "
                  f"({odd_ms:.4f} ms with the odd bands; plain "
                  f"{plain_ms:.3f} ms, two-sort {library_ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
            del out, ref
        del args, base

    q = q_merge
    r, k = 8, 128
    d, i = merge_inputs(r, q, k, dev, seed=8, inf_ids=True)
    multi_clean = (d.transpose(0, 1).reshape(q, r * k).contiguous(),
                   i.transpose(0, 1).reshape(q, r * k).contiguous())
    multi = (odd_values(multi_clean[0]), multi_clean[1].clone())
    e = q // 16  # the fourth list out of order, after the odd bands
    perm = torch.argsort(torch.rand((e, k), device=dev), dim=1)
    for t in multi:
        rows = t[13 * e:14 * e, 3 * k:4 * k]
        rows.copy_(torch.gather(rows, 1, perm))
    del d, i
    ka = kb = k3 = 384
    d, i = merge_inputs(2, q, ka, dev, seed=9, inf_ids=True)
    clean = (d[0].contiguous(), i[0].contiguous(), d[1].contiguous(),
             i[1].contiguous())
    lists = (odd_values(d[0]), i[0].clone(), d[1].contiguous(),
             i[1].contiguous())
    # the first list out of order, after the odd bands
    perm = torch.argsort(torch.rand((e, ka), device=dev), dim=1)
    for t in range(2):
        rows = lists[t][13 * e:14 * e]
        rows.copy_(torch.gather(rows, 1, perm))
    del d, i
    for name, fn, run_args, base, kk, line, row, route in (
            ("merge_topk_multi_wide", mt.merge_topk_multi, multi,
             multi_clean, k, 75, r * k, "wide_merge"),
            ("merge_topk_lists_wide", mt.merge_topk_lists, lists, clean, k3,
             119, ka + kb, "wide_merge")):
        fn.wide_launches = fn.wide_merge_launches = 0
        out = fn(*run_args, k=kk)
        torch.cuda.synchronize()
        if (fn.wide_launches, fn.wide_merge_launches) != (1, 1):
            raise AssertionError(f"{name}: the {route} route did not run")
        plain_fn = (mt.merge_topk_multi_ref if fn is mt.merge_topk_multi
                    else mt.merge_topk_lists_ref)
        ref = plain_fn(*run_args, k=kk)
        _check_lists(f"{name} != plain version", out, ref)
        fin = torch.isfinite(ref[0])
        err = float((out[0][fin] - ref[0][fin]).abs().max())
        _check_lists(f"{name} != plain version (base rows)",
                     fn(*base, k=kk), plain_fn(*base, k=kk))
        odd_ms = time_ms(lambda: fn(*run_args, k=kk), reps=5)
        ms = time_ms(lambda: fn(*base, k=kk), reps=5)
        plain_ms = time_ms(lambda: plain_fn(*base, k=kk), reps=1, warmup=1)
        two = base if fn is mt.merge_topk_multi else (
            torch.cat([base[0], base[2]], 1), torch.cat([base[1], base[3]], 1))
        library_ms = time_ms(lambda: topk_select_ref(*two, kk), reps=3,
                             warmup=1)
        recs[name] = _record(
            name, "merge_topk.cu", f"src/repro/kernels/merge_topk.py:{line}",
            None, ms, plain_ms, q * row * 8 + q * kk * 8, q * (row + kk),
            library_ms, err,
            shape=f"Q={q} row={row} k={kk}", template="wide",
            wide_route=route, odd_rows_ms=odd_ms)
        print(f"kernel: {name} Q={q} row={row} k={kk} ({route} route) "
              f"bitwise equal to its plain version on every row (NaN, -inf, "
              f"-0, negative and unsorted bands included); {ms:.4f} ms "
              f"({odd_ms:.4f} ms with the odd bands; plain "
              f"{plain_ms:.3f} ms, two-sort {library_ms:.3f} ms, bound "
              f"{recs[name]['bound_ms']:.4f} ms by {recs[name]['bound_by']})")
        del out, ref, two
    return recs


NAV_ROW_BYTES = 31 + 20  # a navigating row's state read and written


def nav_phase(dev, n: int = 1_000_000, seed: int = 0):
    """``nav_walk`` on the navigation inputs of a 1M uniform sweep (the
    benchmark cell's world and spec: side 22,500, l_max 8, th_quad 192,
    k = 32, window 256, max_nav 20), recorded pass by pass: the first pass's
    rows and the pass nearest 470,000 rows, each bitwise against
    ``nav_walk_ref`` on all eight outputs and timed beside its byte bound
    and the plain loop; then :func:`nav_inputs`' edge bands at 1M rows
    (l_max 8, a gaussian world on a uniform partition).  One record a
    shape; ``launches`` is filled in from the single path."""
    from repro_torch.core import pipeline as tp
    from repro_torch.core.quadtree import build_index
    from repro_torch.data import make_workload
    from repro_torch.kernels import nav_walk as nw

    side, l_max, k, window = 22_500.0, 8, 32, 256
    pts = make_workload(n, "uniform", seed=seed, side=side).positions()
    index = build_index(torch.tensor(pts, device=dev), (0.0, 0.0), side,
                        l_max=l_max, th_quad=192)
    steps = tp.default_max_nav(l_max)
    passes = []

    def record(index_, *args):
        passes.append(tuple(a.clone() for a in args[:-1]))
        return nw.nav_walk(index_, *args)

    tp.nav_walk = record
    try:
        tp.knn_query_batch(index, pts, np.arange(n, dtype=np.int32), k=k,
                           window=window, backend="fused_bucket")
    finally:
        tp.nav_walk = nw.nav_walk
    torch.cuda.synchronize()
    sizes = [p[0].shape[0] for p in passes]
    middle = min(range(1, len(passes)), key=lambda i: abs(sizes[i] - 470_000))
    shapes = [("first pass", index, passes[0]),
              (f"pass {middle + 1}", index, passes[middle])]
    edge_index = nav_index("gaussian", n, l_max, dev, seed=seed,
                           partition="uniform")
    shapes.append(("edge bands", edge_index,
                   nav_inputs(edge_index, n - n % NAV_BANDS, dev, seed=seed)))
    recs = []
    for label, idx, args in shapes:
        got = nw.nav_walk(idx, *args, steps)
        want = nw.nav_walk_ref(idx, *args, steps)
        torch.cuda.synchronize()
        for name, g, w in zip(("cl", "cr", "act_l", "act_r", "next_right",
                               "s", "e", "found"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"nav_walk ({label}): {name} differs "
                                     f"from the plain loop on "
                                     f"{int((g != w).sum())} rows")
        rows = args[0].shape[0]
        ms = time_ms(lambda: nw.nav_walk(idx, *args, steps), reps=50)
        plain_ms = time_ms(lambda: nw.nav_walk_ref(idx, *args, steps),
                           reps=3, warmup=1)
        found = int(got[7].sum())
        recs.append(_record(
            "nav_walk", "nav_walk.cu",
            "none (the nav_body / try_level fori_loops, "
            "src/repro/core/pipeline.py:281 and :158)", None, ms, plain_ms,
            rows * NAV_ROW_BYTES, 0, None, shape=label, rows=rows,
            found=found, l_max=l_max, max_nav=steps))
        print(f"nav_walk {label}: {rows} rows, {found} found, kernel "
              f"{ms:.4f} ms (bound {recs[-1]['bound_ms']:.4f} ms), plain "
              f"loop {plain_ms:.2f} ms, bitwise")
    print(json.dumps({"nav_passes": sizes}))
    return recs


def _add_shape(recs: dict, name: str, rec: dict):
    """The first shape of a kernel is its record; later shapes' numbers go
    into the record's ``other_shapes``."""
    if name not in recs:
        recs[name] = dict(rec, other_shapes=[])
        return
    recs[name]["other_shapes"].append(
        {key: rec[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "worst_rows",
                                   "odd_rows_ms", "pruned_share", "timing",
                                   "wide_route")
         if key in rec})


def _topk_bound(q: int, c: int, k: int):
    """B4's bytes and operations: each row's d2 read once, the winners' ids
    read and the (d2, id) output written (8 bytes a rank); one comparison
    per entry read and per output, a selection."""
    return q * c * 4 + q * min(k, c) * 4 + q * k * 8, q * (c + k)


def _timed_once(fn) -> float:
    """Milliseconds of one call of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_api_path(dev, full: bool = True, k: int = 32):
    """The kernel API's entry points at the sizes of the S2 / S3 studies.

    Drives ``pairwise_dist_op`` (one query chunk of the brute-force baseline,
    Q = 2048, against 1,000,000 candidates, 10% invalid), ``topk_select_op``
    (Q = 1,000,000 rows of C = 288 = k + W, the SCAN merge row at spec
    defaults; and Q = 8192 rows of C = 2048, S3's window; edge rows) and
    ``bucket_kselect_op`` (Q = 1,000,000 queries against one shared window
    of C = 2048 with 10% invalid and 40 coincident points, k = 32 and 256),
    B4 past its warp queue (the radix select) at ``tkw_shapes`` with
    :func:`odd_values`' bands, and B5's wide routes: ``bucket_kselect_op``
    with 65,536 queries against a window of 16,384 (the staged route) and
    8192 against one of 25,000 (the wide template), with every launch
    count zeroed just before and read just after (B4's radix launches also
    around each shape's own call).  Then
    each output is held bit for bit against its kernel's plain version on
    the card (in row blocks where the plain version's temporaries would be
    large), B4 also against the two-sort merge and B5 against its
    guarantee on every row, and each kernel is timed (B5's wide routes on
    the rows without the odd bands, ``ms``, and with them,
    ``odd_rows_ms``, both held bitwise).  ``full=False`` runs the same
    checks at a few percent of the sizes.
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.refine import masked_argmin_rounds

    n = 1_000_000 if full else 62_500  # the short run also pads Q and C
    q6, c6 = (2048 if full else 256), n
    tk_shapes = ((n, 288), (8192 if full else 1000, 2048))
    # (Q, C, k) past the warp queue, all the radix select: k = 32 past 2048
    # columns (staged in shared memory at both widths), then k past the
    # queue's 256 at C = 3000, 8192, 12,000 and 2048
    tkw_shapes = tuple((q if full else q // 8, c, kk) for q, c, kk in (
        (8192, 8192, k), (2048, 40_000, k), (8192, 3000, 300),
        (2048, 8192, 512), (2048, 12_000, 600), (8192, 2048, 512)))
    q5, c5, k5s = n, 2048, (k, 256)
    # B5 wide: (Q, C, route, seed), the staged route and the wide template
    b5w_shapes = ((65536 if full else 8192, 16_384, "wide_staged", 15),
                  (8192 if full else 1024, 25_000, "wide_template", 16))
    qpos6, ppos6, valid6 = window_inputs(q6, c6, dev, seed=6)
    tk_in = [topk_inputs(q, c, k, dev, seed=4 + i)
             for i, (q, c) in enumerate(tk_shapes)]
    tkw_in = []
    for i, (q, c, kk) in enumerate(tkw_shapes):
        d, ids = topk_inputs(q, c, kk, dev, seed=10 + i)
        tkw_in.append((odd_values(d), ids))
    qpos5, ppos5, valid5 = window_inputs(q5, c5, dev, seed=5)
    b5w_in = [window_inputs(q, c, dev, seed=sd)
              for q, c, _, sd in b5w_shapes]

    _zero_counts()  # the kernel API path's counts start here
    out6 = ops.pairwise_dist_op(qpos6, ppos6, valid6)
    out4 = [ops.topk_select_op(d, i, k=k) for d, i in tk_in]
    out4w, radix4 = [], []  # each radix shape's own count
    for (_, _, kk), (d, i) in zip(tkw_shapes, tkw_in):
        before = tk.topk_select.radix_launches
        out4w.append(ops.topk_select_op(d, i, k=kk))
        radix4.append(tk.topk_select.radix_launches - before)
    out5 = [ops.bucket_kselect_op(qpos5, ppos5, valid5, k=kk) for kk in k5s]
    out5w = [ops.bucket_kselect_op(*a, k=k) for a in b5w_in]
    torch.cuda.synchronize()
    counts = _read_counts()
    n4w = len(tkw_shapes)
    for name, want in (("pairwise_dist", 1), ("topk_select", 2 + n4w),
                       ("topk_select_queue", 2), ("topk_select_radix", n4w),
                       ("topk_select_wide", n4w), ("bucket_kselect", 4),
                       ("bucket_kselect_wide", 2),
                       ("bucket_kselect_wide_staged", 1)):
        if counts[name] != want:
            raise AssertionError(f"kernel API path: {name} launched "
                                 f"{counts[name]} times, want {want}")
    recs = {}

    # ---- B6: bitwise in blocks of 128 query rows.
    qx, qy = qpos6[:, 0].contiguous(), qpos6[:, 1].contiguous()
    px, py = ppos6[:, 0].contiguous(), ppos6[:, 1].contiguous()

    def plain6():
        return [pd.pairwise_dist_ref(qx[r:r + 128], qy[r:r + 128], px, py,
                                     valid6) for r in range(0, q6, 128)]

    for b, ref in zip(range(0, q6, 128), plain6()):
        if not same_values(out6[b:b + 128], ref):
            bad = (out6[b:b + 128] != ref).any(1).nonzero()[:8, 0] + b
            raise AssertionError(f"pairwise_dist != plain version, rows "
                                 f"{bad.tolist()}")
    if out6.shape != (q6, c6) or not torch.isinf(out6[:, ~valid6]).all():
        raise AssertionError("pairwise_dist: bad shape or invalid entries")
    del out6
    cp = -(-c6 // pd.C_TILE) * pd.C_TILE
    pad = lambda t, fill: torch.cat(
        [t, torch.full((cp - c6,), fill, dtype=t.dtype, device=dev)])
    kin = (qx, qy, pad(px, 0.0), pad(py, 0.0), pad(valid6, False))
    ms = time_ms(lambda: pd.pairwise_dist(*kin), reps=10)
    plain_ms = time_ms(lambda: plain6(), reps=1, warmup=1)
    recs["pairwise_dist"] = _record(
        "pairwise_dist", "pairwise_dist.cu",
        "src/repro/kernels/pairwise_dist.py:53", counts["pairwise_dist"], ms,
        plain_ms, q6 * cp * 4 + q6 * 8 + cp * 9, q6 * cp * 5, None,
        shape=f"Q={q6} C={c6} (padded {cp})")
    print(f"kernel: pairwise_dist Q={q6} C={c6} (padded to {cp}) bitwise "
          f"equal to its plain version; {ms:.4f} ms (plain {plain_ms:.3f} "
          f"ms, bound {recs['pairwise_dist']['bound_ms']:.4f} ms by "
          f"{recs['pairwise_dist']['bound_by']})")
    del kin

    # ---- B4: bitwise against masked_argmin_rounds and the two-sort merge,
    # and against masked_argmin_rounds on odd_values' NaN, -inf, -0 and
    # negative bands.
    for (q, c), (d, i), out in zip(tk_shapes, tk_in, out4):
        plain = masked_argmin_rounds(d, i, k)
        two_sort = ops.topk_select_ref(d, i, k)
        err = _check_merge(f"topk_select C={c}", out, plain, two_sort)
        del plain, two_sort
        odd = odd_values(d)
        _check_lists(f"topk_select C={c} != plain version on the odd bands",
                     ops.topk_select_op(odd, i, k=k),
                     masked_argmin_rounds(odd, i, k))
        ms = time_ms(lambda: ops.topk_select_op(d, i, k=k), reps=20)
        odd_ms = time_ms(lambda: ops.topk_select_op(odd, i, k=k), reps=20)
        del odd
        plain_ms = time_ms(lambda: masked_argmin_rounds(d, i, k), reps=2,
                           warmup=1)
        lib_ms = time_ms(lambda: torch.topk(d, k, dim=1, largest=False),
                         reps=10)
        rec = _record("topk_select", "topk_select.cu",
                      "src/repro/kernels/topk_select.py:49",
                      counts["topk_select_queue"], ms, plain_ms,
                      *_topk_bound(q, c, k), lib_ms, err,
                      shape=f"Q={q} C={c} k={k}", template="queue",
                      odd_rows_ms=odd_ms)
        print(f"kernel: topk_select Q={q} C={c} k={k} (warp queue) bitwise "
              f"equal to its plain version and the two-sort merge, and to "
              f"its plain version with the NaN, -inf, -0 and negative "
              f"bands; {ms:.4f} ms ({odd_ms:.4f} ms with those bands; plain "
              f"{plain_ms:.3f} ms, torch.topk {lib_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
        # the worst rows for the warp queue: every entry enters it
        worst = []
        for kind in ("descending", "equal"):
            wd, wi = worst_rows(q, c, kind, dev, seed=c)
            _check_merge(f"topk_select C={c} {kind} rows",
                         ops.topk_select_op(wd, wi, k=k),
                         masked_argmin_rounds(wd, wi, k),
                         ops.topk_select_ref(wd, wi, k))
            worst.append({"rows": kind, "ms": time_ms(
                lambda: ops.topk_select_op(wd, wi, k=k), reps=20)})
            del wd, wi
        rec["worst_rows"] = worst
        print(f"kernel: topk_select Q={q} C={c} k={k} on its worst rows "
              f"bitwise equal to its plain version and the two-sort merge; "
              + ", ".join(f"{w['rows']} {w['ms']:.4f} ms" for w in worst))
        _add_shape(recs, "topk_select", rec)
    del tk_in, out4

    # ---- B4 past its warp queue (the radix select): bitwise against
    # masked_argmin_rounds on the edge bands and the NaN, -inf, -0 and
    # negative ones, each shape timed beside torch.topk on the same rows.
    for (q, c, kk), (d, i), out, launches in zip(tkw_shapes, tkw_in, out4w,
                                                 radix4):
        name = (f"topk_select_wide_c{c}" if kk == k else
                f"topk_select_{'wide_' if c > 2048 else ''}c{c}_k{kk}")
        if launches != 1:
            raise AssertionError(f"{name}: the radix select launched "
                                 f"{launches} times, want 1")
        plain = _in_blocks(lambda a, b: masked_argmin_rounds(a, b, kk),
                           (d, i), blk=2048)
        _check_lists(f"{name} != plain version", out, plain)
        fin = torch.isfinite(plain[0])
        err = float((out[0][fin] - plain[0][fin]).abs().max())
        del plain, fin
        ms = time_ms(lambda: ops.topk_select_op(d, i, k=kk), reps=20)
        plain_ms = time_ms(lambda: masked_argmin_rounds(d, i, kk), reps=1,
                           warmup=1)
        lib_ms = time_ms(lambda: torch.topk(d, kk, dim=1, largest=False),
                         reps=20)
        recs[name] = _record(
            name, "topk_select.cu", "src/repro/kernels/topk_select.py:49",
            launches, ms, plain_ms, *_topk_bound(q, c, kk), lib_ms, err,
            shape=f"Q={q} C={c} k={kk}", template="radix")
        print(f"kernel: {name} Q={q} C={c} k={kk} (radix select) bitwise "
              f"equal to its plain version (NaN, -inf, -0 and negative "
              f"bands included); {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"torch.topk {lib_ms:.3f} ms, bound "
              f"{recs[name]['bound_ms']:.4f} ms by {recs[name]['bound_by']})")
    del tkw_in, out4w

    # ---- B5: bitwise in row blocks, and the guarantee.
    for kk, out in zip(k5s, out5):
        nan_rows = _check_b5(qpos5, ppos5, valid5, out, kk,
                             f"bucket_kselect k={kk}")
        ms = time_ms(lambda: ops.bucket_kselect_op(qpos5, ppos5, valid5,
                                                   k=kk), reps=5)
        plain_ms = time_ms(lambda: _b5_plain(qpos5, ppos5, valid5, kk),
                           reps=1, warmup=1)
        rec = _record("bucket_kselect", "bucket_kselect.cu",
                      "src/repro/kernels/bucket_kselect.py:84",
                      counts["bucket_kselect"] - counts["bucket_kselect_wide"],
                      ms, plain_ms,
                      q5 * 12 + c5 * 9, q5 * c5 * (5 + 3 * 4), None,
                      shape=f"Q={q5} C={c5} k={kk}")
        print(f"kernel: bucket_kselect Q={q5} C={c5} k={kk} bitwise equal to "
              f"its plain version, guarantee held on every row without a NaN "
              f"distance, NaN on the {nan_rows} with one; {ms:.4f} ms "
              f"(plain {plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']})")
        _add_shape(recs, "bucket_kselect", rec)

    # ---- B5's wide routes: bitwise on the odd rows and the clean ones,
    # and the guarantee.
    name = "bucket_kselect_wide"
    for (q, c, route, sd), (qpos, ppos, valid), out in zip(
            b5w_shapes, b5w_in, out5w):
        base = window_inputs(q, c, dev, seed=sd, odd=False)
        nan_rows = _check_b5(qpos, ppos, valid, out, k, f"{name} {route}")
        _check_b5(*base, ops.bucket_kselect_op(*base, k=k), k,
                  f"{name} {route} (base rows)")
        ms = time_ms(lambda: ops.bucket_kselect_op(*base, k=k), reps=3)
        odd_ms = time_ms(lambda: ops.bucket_kselect_op(qpos, ppos, valid,
                                                       k=k), reps=3)
        plain_ms = time_ms(lambda: _b5_plain(*base, k), reps=1, warmup=1)
        rec = _record(
            name, "bucket_kselect.cu", "src/repro/kernels/bucket_kselect.py:84",
            counts["bucket_kselect_wide"], ms, plain_ms, q * 12 + c * 9,
            q * c * (5 + 3 * 4), None, shape=f"Q={q} C={c} k={k}",
            template="wide", wide_route=route, odd_rows_ms=odd_ms)
        _add_shape(recs, name, rec)
        print(f"kernel: {name} Q={q} C={c} k={k} ({route} route) bitwise "
              f"equal to its plain version, with the odd bands and without, "
              f"guarantee held on every row without a NaN distance, NaN on "
              f"the {nan_rows} with one; {ms:.4f} ms ({odd_ms:.4f} ms with "
              f"the odd bands; plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']})")
    return recs


def _b5_plain(qpos, ppos, valid, k: int) -> list:
    """B5's plain version over (Q, 2) queries, in row blocks of at most
    2^27 distances."""
    from repro_torch.kernels import bucket_kselect as bk

    blk = max(8, (1 << 27) // ppos.shape[0])
    px, py = ppos[:, 0].contiguous(), ppos[:, 1].contiguous()
    return [bk.bucket_kselect_ref(qpos[r:r + blk, 0].contiguous(),
                                  qpos[r:r + blk, 1].contiguous(), px, py,
                                  valid, k=k)
            for r in range(0, qpos.shape[0], blk)]


def _check_b5(qpos, ppos, valid, out, k: int, what: str) -> int:
    """B5's output bitwise equal to its plain version, block by block, and
    its guarantee; returns the rows holding a NaN distance."""
    from repro_torch.kernels import pairwise_dist as pd

    px, py = ppos[:, 0].contiguous(), ppos[:, 1].contiguous()
    n_valid = int(valid.sum())
    nan_rows = r = 0
    for ref in _b5_plain(qpos, ppos, valid, k):
        rows = slice(r, r + ref.shape[0])
        if not same_values(out[rows], ref):
            bad = (out[rows] != ref).nonzero()[:8, 0] + r
            raise AssertionError(f"{what} != plain version, rows "
                                 f"{bad.tolist()}")
        d2 = pd.pairwise_dist_ref(qpos[rows, 0].contiguous(),
                                  qpos[rows, 1].contiguous(), px, py, valid)
        if not _guarantee(d2, out[rows], k, n_valid):
            raise AssertionError(f"{what}: the guarantee fails")
        nan_rows += int(torch.isnan(d2).any(1).sum())
        r += ref.shape[0]
        del d2
    return nan_rows


def _guarantee(d2, r, k: int, n_valid: int) -> bool:
    """B5's guarantee on every row without a NaN distance,
    ``count(d2 < r) >= min(k, n_valid)`` (invalid entries are +inf), and
    on a row with one a NaN radius, as the plain version's, unless the
    window holds fewer than k valid entries (then +inf)."""
    nan = torch.isnan(d2).any(1)
    ok = (d2 < r[:, None]).sum(1) >= min(k, n_valid)
    want_nan = nan & (n_valid >= k)
    return bool((torch.where(nan, torch.isnan(r) == want_nan, ok)).all())


def baseline_check(dev, n: int, sample: int = 128, k: int = 32,
                   seed: int = 0):
    """The brute-force baseline (plain PyTorch, no kernel of its own) on the
    card equals the same call on the CPU, ids and distances bit for bit:
    ``sample`` queries of the n-object uniform set, each excluding its own
    object, in chunks of 2048.  Returns the card's milliseconds."""
    from repro_torch.core.baseline import knn_bruteforce_chunked
    from repro_torch.data.generators import make_workload

    pos = make_workload(n, "uniform", seed=seed, side=22_500.0).positions()
    rows = np.sort(np.random.default_rng(seed + 7).choice(n, sample,
                                                          replace=False))
    qid = rows.astype(np.int32)
    run = lambda device: knn_bruteforce_chunked(pos, pos[rows], qid, k=k,
                                                chunk=2048, device=device)
    gi, gd = run(None)
    ci, cd = run("cpu")
    if not (np.array_equal(gi, ci)
            and np.array_equal(gd.view(np.uint32), cd.view(np.uint32))):
        bad = (gi != ci).any(1) | (gd.view(np.uint32)
                                   != cd.view(np.uint32)).any(1)
        raise AssertionError(f"baseline: card != CPU on {int(bad.sum())} of "
                             f"{sample} rows")
    if (gi == qid[:, None]).any() or gi.shape != (sample, k):
        raise AssertionError("baseline: a query found itself, or bad shape")
    ms = _timed_once(lambda: run(None))
    print(f"baseline: knn_bruteforce_chunked {sample} queries x {n} objects "
          f"(chunk 2048, k={k}) on the card equals the CPU bit for bit; "
          f"{ms:.3f} ms on the card")
    return ms


def oracle_check(pos_t, qrows, nn_idx, nn_dist, k, dev, batch=128,
                 qpos_t=None, qid=None):
    """Brute force on the card: full distance rows, lexicographic (d2, id)
    order, the query's own object excluded; ids and distances bitwise.
    Query row i stands at object i's position, or at ``qpos_t[i]``, and
    excludes object i, or ``qid[i]`` (-2: none)."""
    from repro_torch.runtime import fma, sqrt

    px, py = pos_t[:, 0], pos_t[:, 1]
    qx, qy = (px, py) if qpos_t is None else (qpos_t[:, 0], qpos_t[:, 1])
    ids = torch.arange(pos_t.shape[0], device=dev)
    own = None if qid is None else torch.tensor(qid, device=dev)
    for b in range(0, qrows.shape[0], batch):
        rows = torch.tensor(qrows[b:b + batch], device=dev)
        dx = px[None, :] - qx[rows][:, None]
        dy = py[None, :] - qy[rows][:, None]
        d2 = fma(dx, dx, dy * dy)
        d2[ids[None, :] == (rows if own is None else own[rows])[:, None]] = \
            float("inf")
        sd, order = torch.sort(d2, dim=1, stable=True)  # ids ascend already
        want_i = order[:, :k].to(torch.int32).cpu().numpy()
        want_d = sqrt(sd[:, :k]).cpu().numpy()
        got_i = nn_idx[qrows[b:b + batch]]
        got_d = nn_dist[qrows[b:b + batch]]
        if not (np.array_equal(want_i, got_i)
                and np.array_equal(want_d.view(np.uint32),
                                   got_d.view(np.uint32))):
            raise AssertionError("session result != brute-force oracle")


def _same_lists(res, ref) -> np.ndarray:
    """Rows where two tick results differ in ids or distance bits."""
    return (res.nn_idx != ref.nn_idx).any(1) | (
        res.nn_dist.view(np.uint32) != ref.nn_dist.view(np.uint32)).any(1)


def _index_fields_equal(a, b) -> list:
    """The index fields on which two sessions' indexes differ."""
    return [f for f in ("pos", "ids", "codes", "starts", "pyramid",
                        "leaf_level")
            if not torch.equal(getattr(a, f), getattr(b, f))]


def _move(g, pos, n: int, share: float, side: float, ids=None):
    """``share`` of the objects (or ``ids``) moved up to 200 u, clipped to
    the region: (ids, new positions)."""
    if ids is None:
        ids = g.choice(n, int(n * share), replace=False).astype(np.int32)
    ang = g.uniform(0, 2 * np.pi, ids.size)
    r = g.uniform(0, 200.0, ids.size)
    new = pos[ids] + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None]
    return ids, np.clip(new, 0, side - 1e-3).astype(np.float32)


def main_path(dev, n: int, seed: int = 0):
    """The single path, with a ``precision="mixed"`` twin and a
    ``maintenance="incremental"`` twin fed the same data; returns the fp32
    session's and the mixed twin's B1 launches, and the tick records.

    Ticks 0 to 4 are those of the single path before the incremental twin:
    a uniform build, two 1% moves, the gaussian snapshot on the stale
    partition (its drift rebuild finds a clean buffer and only re-decides
    the leaves) and an unchanged tick.  Tick 5 ingests a uniform snapshot
    on the gaussian partition, and a 1% move is staged while it is in flight
    (after its ``submit()``, before its ``result()``), as a serving loop
    stages one: so its drift rebuild finds the move pending, and the
    incremental twin takes the splice route there (counted by a spy on the
    session's ``reindex_objects_delta``), the others ``build_index``.  A
    tick's wall is its ``submit()`` and its ``result()``; the staged move's
    ``update_objects`` is timed apart."""
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.api import session as session_mod
    from repro_torch.data.generators import make_workload

    spec = ServiceSpec(backend="fused_bucket")
    g = np.random.default_rng(seed + 1)
    pos = make_workload(n, "uniform", seed=seed, side=spec.side).positions()
    pos = pos.copy()
    snapshots = {
        3: make_workload(n, "gaussian", seed=seed, side=spec.side,
                         hotspots=25).positions(),
        5: make_workload(n, "uniform", seed=seed + 2,
                         side=spec.side).positions()}

    session = KnnSession(spec)  # device=None: the card
    twin = KnnSession(ServiceSpec(backend="fused_bucket", precision="mixed"))
    inc = KnnSession(ServiceSpec(backend="fused_bucket",
                                 maintenance="incremental"))
    sessions = (session, twin, inc)
    handles = []
    for s in sessions:
        s.ingest_objects(pos)
        handles.append(s.register_queries(pos, np.arange(n, dtype=np.int32)))

    splices = [0]
    splice = session_mod.reindex_objects_delta

    def spy(*a, **kw):
        splices[0] += 1
        return splice(*a, **kw)

    session_mod.reindex_objects_delta = spy
    total = {"fused_scan_merge": 0, "fused_scan_merge_mixed": 0}
    ticks = []
    plan = ["uniform", "move 1%", "move 1%", "gaussian", "gaussian",
            "uniform"]
    staged_at = len(plan) - 1  # the tick with a move staged in flight
    drift_splices = 0
    try:
        for t, step in enumerate(plan):
            if step == "move 1%":
                ids, new = _move(g, pos, n, 0.01, spec.side)
                pos[ids] = new
                for s, h in zip(sessions, handles):
                    s.update_objects(ids, new)
                    s.update_queries(h, pos)
            elif t in snapshots:
                pos = snapshots[t].copy()
                for s, h in zip(sessions, handles):
                    s.ingest_objects(pos)
                    s.update_queries(h, pos)
            staged = (_move(g, pos, n, 0.01, spec.side) if t == staged_at
                      else None)
            runs = []
            for s in sessions:
                _zero_counts()  # this session's counts of this tick
                torch.cuda.reset_peak_memory_stats()
                before = splices[0]
                t0 = time.perf_counter()
                hd = s.submit()
                submit_s = time.perf_counter() - t0
                update_ms = None
                if staged is not None:
                    t1 = time.perf_counter()
                    s.update_objects(*staged)
                    update_ms = (time.perf_counter() - t1) * 1e3
                t1 = time.perf_counter()
                res = hd.result()
                runs.append({"res": res, "handle": hd,
                             "wall_ms": (submit_s + time.perf_counter()
                                         - t1) * 1e3,
                             "update_ms": update_ms,
                             "counts": _read_counts(),
                             "peak": torch.cuda.max_memory_allocated(),
                             "splices": splices[0] - before})
            r32, rmx, rin = runs
            res = r32["res"]
            launches = r32["counts"]["fused_scan_merge"]
            launches_m = rmx["counts"]["fused_scan_merge_mixed"]
            for label, run, own, other in (
                    ("fp32 session", r32, "fused_scan_merge",
                     "fused_scan_merge_mixed"),
                    ("mixed twin", rmx, "fused_scan_merge_mixed",
                     "fused_scan_merge"),
                    ("incremental twin", rin, "fused_scan_merge",
                     "fused_scan_merge_mixed")):
                if run["counts"][own] < 1 or run["counts"][other]:
                    raise AssertionError(f"tick {t}: the {label} launched "
                                         f"{run['counts']}")
            total["fused_scan_merge"] += launches
            total["fused_scan_merge_mixed"] += launches_m
            if res.nn_idx.shape != (n, spec.k) or not np.isfinite(
                    res.nn_dist).all():
                raise AssertionError(f"tick {t}: malformed result")
            for label, run in (("mixed", rmx), ("incremental", rin)):
                other = run["res"]
                bad = _same_lists(other, res)
                if bad.any() or (other.iterations, other.candidates) != (
                        res.iterations, res.candidates):
                    raise AssertionError(
                        f"tick {t}: the {label} twin differs from fp32 on "
                        f"{int(bad.sum())} rows, iterations "
                        f"{other.iterations} / {res.iterations}, candidates "
                        f"{other.candidates} / {res.candidates}")
            if rin["counts"]["fused_scan_merge"] != launches:
                raise AssertionError(f"tick {t}: the incremental twin "
                                     f"launched B1 {rin['counts']}, fp32 "
                                     f"{launches}")
            # the first build and the unchanged tick skip; a snapshot
            # re-sorts; a move re-sorts, or splices under the incremental
            # spec
            for run, splice_mode in ((r32, "rebuild"), (rmx, "rebuild"),
                                     (rin, "incremental")):
                want = ("skip" if t in (0, 4) else
                        splice_mode if step == "move 1%" else "rebuild")
                if run["res"].maintenance != want:
                    raise AssertionError(
                        f"tick {t}: maintenance {run['res'].maintenance}, "
                        f"want {want}")
            drift = r32["handle"].rebuilt_post
            if any(run["handle"].rebuilt_post != drift for run in runs):
                raise AssertionError(f"tick {t}: drift rebuilds "
                                     f"{[r['handle'].rebuilt_post for r in runs]}")
            # only the incremental twin's drift rebuild with a staged move
            # splices
            if rin["splices"] != int(drift and staged is not None) or \
                    r32["splices"] or rmx["splices"]:
                raise AssertionError(f"tick {t}: spliced drift rebuilds "
                                     f"{[r['splices'] for r in runs]}")
            drift_splices += rin["splices"]
            diff = _index_fields_equal(session.index, inc.index)
            if diff:
                raise AssertionError(f"tick {t}: the incremental twin's index "
                                     f"differs in {diff}")
            sample = g.choice(n, 1024, replace=False)
            oracle_check(torch.tensor(pos, device=dev), sample, res.nn_idx,
                         res.nn_dist, spec.k, dev)
            rec = {"tick": t, "step": step, "n_objects": n,
                   "wall_ms": r32["wall_ms"], "iterations": res.iterations,
                   "candidates": res.candidates, "launches": launches,
                   "rebuilt": res.rebuilt, "maintenance": res.maintenance,
                   "max_memory_allocated": r32["peak"],
                   "oracle_rows": 1024, "oracle": "bitwise",
                   "mixed_wall_ms": rmx["wall_ms"],
                   "mixed_launches": launches_m,
                   "mixed_twin": "bitwise, all rows",
                   "incremental_wall_ms": rin["wall_ms"],
                   "incremental_max_memory_allocated": rin["peak"],
                   "incremental_maintenance": rin["res"].maintenance,
                   "incremental_drift_splice": rin["splices"],
                   "incremental_twin": "bitwise, all rows and index fields"}
            if staged is not None:
                rec["staged_move_update_ms"] = [r["update_ms"] for r in runs]
            print("tick " + json.dumps(rec))
            ticks.append(rec)
            if staged is not None:  # the move the sessions took in flight
                pos[staged[0]] = staged[1]
    finally:
        session_mod.reindex_objects_delta = splice
    if n >= 1_000_000 and drift_splices < 1:
        raise AssertionError("tick 5's drift rebuild did not take the "
                             "splice route on the incremental twin")
    for s in sessions:
        s.finalize_pending()
    return total, ticks


def _counters():
    """Each kernel's launch counter: (wrapper, attribute)."""
    from repro_torch.kernels import bucket_kselect as bk
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import topk_select as tk

    return {"fused_scan_merge": (fs.fused_scan_merge, "launches"),
            "fused_scan_merge_mixed": (fs.fused_scan_merge, "mixed_launches"),
            "fused_scan_merge_wide": (fs.fused_scan_merge, "wide_launches"),
            "fused_scan_merge_wide_queue": (fs.fused_scan_merge,
                                            "wide_queue_launches"),
            "fused_scan_merge_wide_merge": (fs.fused_scan_merge,
                                            "wide_merge_launches"),
            "merge_topk_multi": (mt.merge_topk_multi, "launches"),
            "merge_topk_multi_wide": (mt.merge_topk_multi, "wide_launches"),
            "merge_topk_multi_wide_merge": (mt.merge_topk_multi,
                                            "wide_merge_launches"),
            "merge_topk_lists": (mt.merge_topk_lists, "launches"),
            "merge_topk_lists_wide": (mt.merge_topk_lists, "wide_launches"),
            "merge_topk_lists_wide_merge": (mt.merge_topk_lists,
                                            "wide_merge_launches"),
            "topk_select": (tk.topk_select, "launches"),
            "topk_select_wide": (tk.topk_select, "wide_launches"),
            "topk_select_queue": (tk.topk_select, "queue_launches"),
            "topk_select_radix": (tk.topk_select, "radix_launches"),
            "topk_select_global": (tk.topk_select, "global_launches"),
            "bucket_kselect": (bk.bucket_kselect, "launches"),
            "bucket_kselect_wide": (bk.bucket_kselect, "wide_launches"),
            "bucket_kselect_wide_staged": (bk.bucket_kselect,
                                           "wide_staged_launches"),
            "pairwise_dist": (pd.pairwise_dist, "launches")}


def _zero_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _fold_f32(values) -> np.float32:
    """Left fold in shard order: how the plans total the shard counters."""
    acc = np.float32(values[0])
    for v in values[1:]:
        acc = np.float32(acc + np.float32(v))
    return acc


# phase 9's two object-axis paths: label -> (first snapshot, plan fields)
OBJECT_PATHS = {
    "a": ("uniform", dict(plan="object_sharded", mesh_shape=4,
                          partitioner="equal", merge="fused_multi")),
    "b": ("gaussian", dict(plan="hybrid", mesh_shape=(2, 3),
                           partitioner="cost_balanced", merge="fused_merge")),
}


def _object_steps(n: int, first: str, seed: int, side: float):
    """An object path's data: the first snapshot and each tick's step,
    ``(name, moved ids, their new positions)`` (None, None on the first)."""
    from repro_torch.data.generators import make_workload

    g = np.random.default_rng(seed + 1)
    kw = {"hotspots": 25} if first == "gaussian" else {}
    pos = make_workload(n, first, seed=seed, side=side, **kw).positions()
    ids = g.choice(n, n // 100, replace=False).astype(np.int32)
    ang = g.uniform(0, 2 * np.pi, ids.size)
    r = g.uniform(0, 200.0, ids.size)
    new = pos[ids] + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None]
    new = np.clip(new, 0, side - 1e-3).astype(np.float32)
    return pos.copy(), [(first, None, None), ("move 1%", ids, new)]


def object_path(dev, n: int, label: str, seed: int, keep=None):
    """An object-axis session (:data:`OBJECT_PATHS`) beside a ``single``
    twin, over two ticks: the first snapshot and a 1% move.  Returns the
    path's kernel launches (its own session only) and ticks; ``keep`` (a
    list) receives each tick's lists and cost EMA for the distributed
    phase."""
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.core.balance import straggler_gap

    first, plan_kw = OBJECT_PATHS[label]
    spec = ServiceSpec(backend="fused_bucket", **plan_kw)
    pos, steps = _object_steps(n, first, seed, spec.side)
    session, twin = KnnSession(spec), KnnSession(ServiceSpec(
        backend="fused_bucket"))
    handles = []
    for s in (session, twin):
        s.ingest_objects(pos)
        handles.append(s.register_queries(pos, np.arange(n, dtype=np.int32)))
    plan = session.plan
    od = plan.object_axis_size
    qd = getattr(plan, "query_devices", 1)
    print(f"path {label}: {plan.describe()}, N={n}")
    totals = {name: 0 for name in _counters()}
    ticks = []
    for t, (step, ids, new) in enumerate(steps):
        if ids is not None:
            pos[ids] = new
            for s, h in zip((session, twin), handles):
                s.update_objects(ids, new)
                s.update_queries(h, pos)
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h = session.submit()
        bounds = session._obj_bounds.cpu().numpy()  # this tick's partition
        res = h.result()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        ref = twin.submit().result()
        for name, c in launches.items():
            totals[name] += c
        bad = _same_lists(res, ref)
        if bad.any():
            raise AssertionError(f"{label} tick {t}: {int(bad.sum())} rows "
                                 "differ from the single-plan twin")
        sc = res.shard_candidates
        if _fold_f32(sc) != np.float32(res.candidates):
            raise AssertionError(f"{label} tick {t}: shard candidates "
                                 f"{sc.tolist()} do not sum to "
                                 f"{res.candidates}")
        if not (bounds[0] == 0 and bounds[-1] == n
                and np.all(np.diff(bounds) >= 0) and bounds.size == od + 1):
            raise AssertionError(f"{label} tick {t}: bad object bounds "
                                 f"{bounds.tolist()}")
        owning = int((res.shard_iterations.reshape(qd, od) > 0).any(1).sum())
        if launches["fused_scan_merge"] < 1:
            raise AssertionError(f"{label} tick {t}: fused_scan_merge idle")
        if plan.merge == "fused_multi" and launches["merge_topk_multi"] != qd:
            raise AssertionError(f"{label} tick {t}: merge_topk_multi "
                                 f"launched {launches['merge_topk_multi']}")
        if plan.merge == "fused_merge" and launches["merge_topk_lists"] != (
                owning * (od - 1)):
            raise AssertionError(f"{label} tick {t}: merge_topk_lists "
                                 f"launched {launches['merge_topk_lists']}, "
                                 f"want {od - 1} per owning query shard "
                                 f"({owning})")
        rec = {"path": label, "tick": t, "step": step, "n_objects": n,
               "wall_ms": wall_ms, "iterations": res.iterations,
               "candidates": res.candidates,
               "shard_candidates": sc.tolist(),
               "shard_iterations": res.shard_iterations.tolist(),
               "straggler_gap": straggler_gap(sc),
               "object_bounds": bounds.tolist(), "launches": launches,
               "maintenance": res.maintenance, "rebuilt": res.rebuilt,
               "max_memory_allocated": peak, "twin": "bitwise, all rows"}
        print("tick " + json.dumps(rec))
        ticks.append(rec)
        if keep is not None:
            keep.append({"idx": res.nn_idx, "dist": res.nn_dist,
                         "qcost": session._qcost.cpu().numpy()})
    session.finalize_pending()
    twin.finalize_pending()
    return totals, ticks


# the distributed phase: a spawned run's time limit, and the ticks' fields
# every rank must give with phase 9's bits
RANK_RUN_TIMEOUT_S = 420
RANK_FIELDS = ("shard_candidates", "shard_iterations", "object_bounds",
               "iterations", "candidates", "qcost")


def _free_port() -> int:
    """A TCP port on this host that nothing listens on (the ranks' store)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_ranks(argv: list, world: int) -> list:
    """``world`` processes of ``argv`` with the environment
    ``torch.distributed.run`` gives its ranks."""
    port = str(_free_port())
    procs = []
    for r in range(world):
        penv = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                    WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, env=penv, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs, what: str) -> list:
    deadline = time.monotonic() + RANK_RUN_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{what}: a process did not finish within "
                             f"{RANK_RUN_TIMEOUT_S} s") from None
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: process {r} exited "
                                 f"{p.returncode}:\n{log[-6000:]}")
    return logs


def rank_path(label: str, n: int, ref_dir: str) -> int:
    """One rank of an object path laid onto ranks (run by
    :func:`distributed`): phase 9's session, with no twin, held against
    phase 9's records in ``ref_dir``; writes its report there."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.launch.mesh import init_from_env, mesh_cell

    dev, backend = init_from_env("cuda")
    rank = dist.get_rank()
    _wait_for(Path(ref_dir) / f"{label}.go")  # started up during phase 9
    first, plan_kw = OBJECT_PATHS[label]
    spec = ServiceSpec(backend="fused_bucket", **plan_kw)
    pos, steps = _object_steps(n, first, 0, spec.side)
    session = KnnSession(spec, device=dev)
    session.ingest_objects(pos)
    h = session.register_queries(pos, np.arange(n, dtype=np.int32))
    plan = session.plan
    cell = mesh_cell(plan.mesh)
    od = plan.object_axis_size
    report = {"rank": rank, "backend": backend, "device": str(dev),
              "cell": list(cell), "describe": plan.describe(), "ticks": []}
    # host seconds in the plan's gathers, the wait for the group's slowest
    # rank included (the device drained before and after each)
    gather_s = [0.0]
    all_gather = dist.all_gather

    def timed_gather(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            return all_gather(*a, **kw)
        finally:
            torch.cuda.synchronize(dev)
            gather_s[0] += time.perf_counter() - t0

    dist.all_gather = timed_gather
    for t, (step, ids, new) in enumerate(steps):
        if ids is not None:
            pos[ids] = new
            session.update_objects(ids, new)
            session.update_queries(h, pos)
        _zero_counts()
        gather_s[0] = 0.0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        handle = session.submit()
        bounds = session._obj_bounds.cpu().numpy()
        res = handle.result()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        ref = np.load(Path(ref_dir) / f"{label}_t{t}.npz")
        got = {"shard_candidates": res.shard_candidates,
               "shard_iterations": res.shard_iterations,
               "object_bounds": bounds, "iterations": res.iterations,
               "candidates": np.float32(res.candidates)}
        got["qcost"] = session._qcost.cpu().numpy()
        differ = [f for f in RANK_FIELDS
                  if np.asarray(got[f], ref[f].dtype).tobytes()
                  != ref[f].tobytes() or np.shape(got[f]) != ref[f].shape]
        if [res.maintenance, bool(res.rebuilt)] != [str(ref["maintenance"]),
                                                     bool(ref["rebuilt"])]:
            differ.append("rebuild decision")
        rows = (res.nn_idx != ref["idx"]).any(1) | (
            res.nn_dist.view(np.uint32) != ref["dist"].view(np.uint32)).any(1)
        owns = bool(res.shard_iterations.reshape(-1, od)[cell[0]].any())
        b1, b2, b3 = (launches[k] for k in ("fused_scan_merge",
                                              "merge_topk_multi",
                                              "merge_topk_lists"))
        report["ticks"].append({
            "tick": t, "step": step, "wall_ms": wall_ms,
            "gather_ms": gather_s[0] * 1e3, "peak": peak,
            "iterations": res.iterations, "owns_rows": owns,
            "rows_differ": int(rows.sum()), "fields_differ": differ,
            "launches": {"B1": b1, "B2": b2, "B3": b3}})
        if rows.any() or differ:
            raise AssertionError(f"rank {rank} {label} tick {t}: "
                                 f"{int(rows.sum())} rows and {differ} "
                                 "differ from phase 9's logical shards")
        want = (1, 0) if plan.merge == "fused_multi" else (
            0, od - 1 if owns else 0)
        if (b2, b3) != want or (owns and b1 < 1):
            raise AssertionError(f"rank {rank} {label} tick {t}: launches "
                                 f"B1 {b1}, B2 {b2}, B3 {b3}, want B2/B3 "
                                 f"{want}")
    session.finalize_pending()
    dist.destroy_process_group()
    (Path(ref_dir) / f"{label}_rank{rank}.json").write_text(
        json.dumps(report))
    return 0


def start_distributed(n: int) -> tuple:
    """:func:`distributed`'s ranks, started during phase 9: each starts up
    and waits for its path's go.  Returns (their directory, {path: its
    ranks})."""
    import tempfile

    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = {}
    for label in ("a", "b"):
        shape = OBJECT_PATHS[label][1]["mesh_shape"]
        world = shape if isinstance(shape, int) else shape[0] * shape[1]
        procs[label] = _start_ranks(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-path",
             label, "--n-objects", str(n), "--ref-dir", ref_dir], world)
    return ref_dir, procs


def distributed(n: int, kept: dict, ticks: dict, card: str,
                started: tuple) -> dict:
    """Phase 9's paths (a) and (b) laid onto gloo ranks that share the one
    card, one grid cell per rank (:func:`start_distributed`'s), each rank
    held against phase 9's records (``kept``, ``ticks``) bit for bit.
    Returns each kernel's launches summed over the ranks."""
    totals = {"B1": 0, "B2": 0, "B3": 0}
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ref_dir, procs = started
    try:
        for label in ("a", "b"):
            for t, (lists, rec) in enumerate(zip(kept[label], ticks[label])):
                np.savez(Path(ref_dir) / f"{label}_t{t}.npz",
                         idx=lists["idx"], dist=lists["dist"],
                         qcost=lists["qcost"],
                         shard_candidates=np.float32(rec["shard_candidates"]),
                         shard_iterations=np.int32(rec["shard_iterations"]),
                         object_bounds=np.int32(rec["object_bounds"]),
                         iterations=np.int32(rec["iterations"]),
                         candidates=np.float32(rec["candidates"]),
                         maintenance=rec["maintenance"],
                         rebuilt=rec["rebuilt"])
            world = len(procs[label])
            t0 = time.perf_counter()
            (Path(ref_dir) / f"{label}.go").write_text("")
            _join(procs[label], f"path {label} ranks")
            reports = [json.loads((Path(ref_dir) / f"{label}_rank{r}.json")
                       .read_text()) for r in range(world)]
            for rep in reports:
                for tk in rep["ticks"]:
                    for k in totals:
                        totals[k] += tk["launches"][k]
            print("distributed " + json.dumps({
                "run": label, "plan": reports[0]["describe"], "n_objects": n,
                "world": world, "backend": reports[0]["backend"],
                "seconds": time.perf_counter() - t0,
                "ranks": [{"rank": rep["rank"], "cell": rep["cell"],
                           **{k: [tk[k] for tk in rep["ticks"]]
                              for k in ("wall_ms", "gather_ms", "peak",
                                        "iterations", "owns_rows",
                                        "rows_differ", "launches")}}
                          for rep in reports],
                "held": "every rank bitwise to phase 9 (lists, shard "
                        "counters, qcost_next, object bounds, decisions)",
                "card": card}), flush=True)
    finally:
        _stop([p for ranks in procs.values() for p in ranks])
        shutil.rmtree(ref_dir, ignore_errors=True)
    return totals


def driver_ranks(n: int, card: str):
    """The ``knn`` driver under ``torch.distributed.run`` on one rank with
    a card of its own: the NCCL path builds its groups and runs the plan's
    collectives on the card, and the rank's lists pass its own check."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "repro_torch.launch.serve", "knn",
            "--objects", str(n), "--ticks", "3", "--plan", "hybrid"]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = _join([subprocess.Popen(argv, env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)],
                "the knn driver under torch.distributed.run")[0]
    for want in ("backend=nccl world=1", "1 ranks ended every tick with the "
                 "same lists"):
        if want not in log:
            raise AssertionError(f"knn driver: no {want!r} in\n{log[-4000:]}")
    tick_lines = [ln for ln in log.splitlines() if ln.startswith("[knn] tick")]
    print("distributed " + json.dumps({
        "run": "knn driver", "argv": argv[3:], "n_objects": n, "world": 1,
        "backend": "nccl", "seconds": time.perf_counter() - t0,
        "ticks": tick_lines, "card": card}), flush=True)


# the server on ranks: objects, plan, and the ranks' world; host-bound, at
# 12,500 objects, so that the whole run keeps inside its time limit
RANK_SERVER_N = 12_500
RANK_SERVER_PLAN = dict(plan="object_sharded", mesh_shape=4,
                        merge="fused_multi")
RANK_SERVER_WORLD = 4


def server_ticks(dev, n: int, gather_s=None, seed: int = 0) -> list:
    """The four-tenant server of :func:`server_path` over ``n`` uniform
    objects on ``RANK_SERVER_PLAN`` (``fused_bucket``, spatial
    invalidation, the stab budget scaled with N), through its four steps:
    the build, an unchanged tick (all from the cache), tenant 2 moves N /
    500 objects (the stab), tenant 3 moves 1% (over the budget: the epoch
    clears).  Returns per tick its counters, the entries it evicted, a
    digest of each tenant group's rows, and its wall, B1/B2 launches, peak
    and (with ``gather_s``, a one-element list the caller's timed gather
    adds to) its seconds in the plan's gathers.  Under a process group
    every rank runs it with a replica of the server."""
    import hashlib

    from repro_torch.api import ServiceSpec
    from repro_torch.data.generators import make_workload
    from repro_torch.serve import KnnServer

    spec = ServiceSpec(backend="fused_bucket", **RANK_SERVER_PLAN)
    pos = make_workload(n, "uniform", seed=seed + 7, side=spec.side
                        ).positions().copy()
    g = np.random.default_rng(seed + 8)
    qid = np.arange(n, dtype=np.int32)
    server = KnnServer(spec, device=dev, invalidation="spatial",
                       cache_entries=1_048_576,
                       stab_budget=4096 * n // 1_000_000)
    server.ingest_objects(pos)
    tenants, groups, _ = _four_tenants(server, pos.copy(), qid)
    steps = [("build", None, 0), ("unchanged", None, 0),
             ("tenant 2 moves N / 500", 2, n // 500),
             ("tenant 3 moves 1%", 3, n // 100)]
    out = []
    for step, mover, m in steps:
        inval0 = server.cache.stats.invalidations
        if mover is not None:
            ids, new = _move(g, pos, n, 0.0, spec.side,
                             ids=g.choice(n, m, replace=False
                                          ).astype(np.int32))
            pos[ids] = new
            tenants[mover].update_objects(ids, new)
        _zero_counts()
        if gather_s is not None:
            gather_s[0] = 0.0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        st = server.submit()
        res = st.result()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        digests = []
        for group in groups:
            ii, dd, qq = st.result_for(group)
            digests.append(hashlib.sha256(
                ii.tobytes() + dd.tobytes() + qq.tobytes()).hexdigest())
        out.append({
            "step": step, "rows": res.rows_total, "unique": res.rows_unique,
            "computed": res.rows_computed, "dedup_hits": res.dedup_hit_rows,
            "cache_hits": res.cache_hit_rows, "epoch": res.epoch,
            "rebuilt": bool(res.rebuilt), "submitted": res.inner is not None,
            "evicted": server.cache.stats.invalidations - inval0,
            "invalidation": server.cache.last_invalidation,
            "digests": digests, "wall_ms": wall_ms,
            "gather_ms": None if gather_s is None else gather_s[0] * 1e3,
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": {"B1": counts["fused_scan_merge"],
                         "B2": counts["merge_topk_multi"]}})
    server.session.finalize_pending()
    return out


# what every rank's server ticks must give as the logical run gave them
SERVER_HELD = ("step", "rows", "unique", "computed", "dedup_hits",
               "cache_hits", "epoch", "rebuilt", "submitted", "evicted",
               "invalidation", "digests")


def rank_server(n: int, ref_dir: str) -> int:
    """One rank of the server on ranks (run by :func:`server_ranks`):
    :func:`server_ticks` with a replica of the server on this rank, every
    tick held against the logical run's records in ``ref_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_env

    dev, backend = init_from_env("cuda")
    rank = dist.get_rank()
    _wait_for(Path(ref_dir) / "server.go")  # started up beside the logical
    gather_s = [0.0]
    all_gather = dist.all_gather

    def timed_gather(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            return all_gather(*a, **kw)
        finally:
            torch.cuda.synchronize(dev)
            gather_s[0] += time.perf_counter() - t0

    dist.all_gather = timed_gather
    ticks = server_ticks(dev, n, gather_s)
    dist.destroy_process_group()
    ref = json.loads((Path(ref_dir) / "server_logical.json").read_text())
    for t, (got, want) in enumerate(zip(ticks, ref)):
        differ = [f for f in SERVER_HELD if got[f] != want[f]]
        if differ:
            raise AssertionError(f"rank {rank} server tick {t}: {differ} "
                                 "differ from the logical server's")
        if got["submitted"] and got["launches"]["B2"] != 1:
            raise AssertionError(f"rank {rank} server tick {t}: B2 "
                                 f"launched {got['launches']['B2']} times")
    (Path(ref_dir) / f"server_rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "backend": backend, "device": str(dev),
         "ticks": ticks}))
    return 0


def server_ranks(n: int, card: str) -> dict:
    """The four-tenant server on ``RANK_SERVER_WORLD`` gloo ranks sharing
    the card, one replica a rank, each rank's ticks bitwise equal to the
    logical-shard server run here first; then the ``knn`` driver with four
    tenants under ``torch.distributed.run`` on as many ranks.  Returns the
    B1 and B2 launches summed over the ranks."""
    import tempfile

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_server_")
    # the ranks start up while the logical server runs, and wait for it
    procs = _start_ranks([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--rank-server", "--n-objects", str(n),
                          "--ref-dir", ref_dir], RANK_SERVER_WORLD)
    totals = {"B1": 0, "B2": 0}
    try:
        t0 = time.perf_counter()
        logical = server_ticks(dev, n)
        logical_s = time.perf_counter() - t0
        dup = min(65_536, len(range(1, n, 4)))  # tenant 0's duplicate rows
        for t, tk in enumerate(logical):
            exp = {0: (n, dup, 0), 1: (0, 0, n + dup), 3: (n, dup, 0)}.get(t)
            got = (tk["computed"], tk["dedup_hits"], tk["cache_hits"])
            if (exp is not None and got != exp) or (
                    t == 2 and not 0 < tk["computed"] == tk["evicted"] < n
            ) or (t == 3 and tk["epoch"] != logical[2]["epoch"] + 1) or (
                    tk["submitted"] != (t != 1)):
                raise AssertionError(f"logical server tick {t}: {tk}")
        torch.cuda.empty_cache()
        (Path(ref_dir) / "server_logical.json").write_text(
            json.dumps(logical))
        t0 = time.perf_counter()
        (Path(ref_dir) / "server.go").write_text("")
        _join(procs, "server ranks")
        ranks_s = time.perf_counter() - t0
        reports = [json.loads((Path(ref_dir) / f"server_rank{r}.json")
                   .read_text()) for r in range(RANK_SERVER_WORLD)]
    finally:
        _stop(procs)
        shutil.rmtree(ref_dir, ignore_errors=True)
    for rep in reports:
        for tk in rep["ticks"]:
            for k in totals:
                totals[k] += tk["launches"][k]
    print("distributed " + json.dumps({
        "run": "server", "plan": RANK_SERVER_PLAN, "n_objects": n,
        "tenants": 4, "world": RANK_SERVER_WORLD,
        "backend": reports[0]["backend"], "seconds": ranks_s,
        "logical_seconds": logical_s,
        "ticks": [{k: tk[k] for k in SERVER_HELD if k != "digests"}
                  for tk in logical],
        "logical_wall_ms": [tk["wall_ms"] for tk in logical],
        "logical_peak": [tk["peak"] for tk in logical],
        "ranks": [{"rank": rep["rank"],
                   **{k: [tk[k] for tk in rep["ticks"]]
                      for k in ("wall_ms", "gather_ms", "peak",
                                "launches")}} for rep in reports],
        "held": "every rank's tenant rows (digests) and tick counters equal "
                "the logical server's", "card": card}), flush=True)
    n_driver = n // 4
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(RANK_SERVER_WORLD), "-m",
            "repro_torch.launch.serve", "knn", "--objects", str(n_driver),
            "--ticks", "1", "--tenants", "4", "--plan", "object_sharded"]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    log = _join([subprocess.Popen(argv, env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)],
                "the knn driver with tenants under torch.distributed.run")[0]
    for want in (f"backend=gloo world={RANK_SERVER_WORLD}",
                 f"{RANK_SERVER_WORLD} ranks ended every tick with the same "
                 "lists for each of 4 tenants"):
        if want not in log:
            raise AssertionError(f"knn --tenants: no {want!r} in\n"
                                 f"{log[-4000:]}")
    print("distributed " + json.dumps({
        "run": "knn driver, 4 tenants", "argv": argv[3:],
        "n_objects": n_driver, "world": RANK_SERVER_WORLD, "backend": "gloo",
        "seconds": time.perf_counter() - t0,
        "ticks": [ln for ln in log.splitlines()
                  if ln.startswith("[knn] tick")], "card": card}),
          flush=True)
    return totals


def _tick(session):
    """One tick of ``session``: (result, wall ms, counts, peak memory), its
    counts zeroed just before and read just after."""
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = session.submit().result()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return res, wall_ms, _read_counts(), torch.cuda.max_memory_allocated()


def wide_sessions(dev, n: int, n_axis: int, seed: int = 0):
    """Specs whose rows pass the narrow templates' widths, one query per
    object, one uniform tick each, (a) and (b) at ``n`` objects, the
    host-bound object-axis sessions (c) and (d) at ``n_axis``:
    (a) ``single`` with ``window=1024`` (B1 wide, k + W = 1056) and its
        ``precision="mixed"`` twin, against a 1,024-row brute-force oracle;
    (b) ``single`` with ``k=512`` (B1 wide, k + W = 768) and its mixed twin,
        against the oracle;
    (c) ``object_sharded`` 8, ``fused_multi``, k = 128 (B2 wide, R * k =
        1024) against a ``single`` twin on every row;
    (d) ``hybrid`` (2, 3), ``cost_balanced``, ``fused_merge``, k = 384 (B3
        wide, ka + kb = 768) against a ``single`` twin on every row.
    Checks that every wide launch took its route (the wide queue at
    k = 32, the wide merge past k = 256, B2's and B3's wide merges) and
    returns each wide record's launches on its session (B1 at k = 384
    from (d))."""
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.data.generators import make_workload

    side = ServiceSpec().side
    worlds = {m: make_workload(m, "uniform", seed=seed + 3,
                               side=side).positions() for m in {n, n_axis}}
    pos = worlds[n]
    g = np.random.default_rng(seed + 4)
    launches = {}

    def session(m=n, **kw):
        s = KnnSession(ServiceSpec(backend="fused_bucket", **kw))
        s.ingest_objects(worlds[m])
        s.register_queries(worlds[m], np.arange(m, dtype=np.int32))
        return s

    def report(label, res, wall_ms, counts, peak, **extra):
        rec = {"path": label, "n_objects": res.nn_idx.shape[0],
               "wall_ms": wall_ms,
               "iterations": res.iterations, "candidates": res.candidates,
               "launches": {k: v for k, v in counts.items() if v},
               "max_memory_allocated": peak, **extra}
        print("wide " + json.dumps(rec))

    pos_t = torch.tensor(pos, device=dev)
    for label, kw in (("single window=1024", dict(window=1024)),
                      ("single k=512", dict(k=512))):
        res, wall_ms, counts, peak = _tick(session(**kw))
        res_m, wall_m, counts_m, _ = _tick(session(precision="mixed", **kw))
        w = kw.get("window", 256)
        k = kw.get("k", 32)
        key = f"w{w}_k{k}"
        route = "fused_scan_merge_wide_" + ("queue" if k <= 256 else "merge")
        for c in (counts, counts_m):
            if c["fused_scan_merge_wide"] < 1 or \
                    c[route] != c["fused_scan_merge_wide"]:
                raise AssertionError(f"{label}: not every wide launch took "
                                     f"{route}")
        launches[f"fused_scan_merge_wide_{key}"] = counts[
            "fused_scan_merge_wide"]
        launches[f"fused_scan_merge_mixed_wide_{key}"] = counts_m[
            "fused_scan_merge_wide"]
        bad = _same_lists(res_m, res)
        if bad.any() or (res_m.iterations, res_m.candidates) != (
                res.iterations, res.candidates):
            raise AssertionError(f"{label}: the mixed twin differs on "
                                 f"{int(bad.sum())} rows")
        if res.nn_idx.shape != (n, k) or not np.isfinite(res.nn_dist).all():
            raise AssertionError(f"{label}: malformed result")
        oracle_check(pos_t, g.choice(n, 1024, replace=False), res.nn_idx,
                     res.nn_dist, k, dev)
        report(label, res, wall_ms, counts, peak, oracle="bitwise, 1024 rows",
               mixed_wall_ms=wall_m, mixed_twin="bitwise, all rows")

    for label, kernel, kw in (
            ("object_sharded 8 fused_multi k=128", "merge_topk_multi_wide",
             dict(k=128, plan="object_sharded", mesh_shape=8,
                  partitioner="equal", merge="fused_multi")),
            ("hybrid (2, 3) fused_merge k=384", "merge_topk_lists_wide",
             dict(k=384, plan="hybrid", mesh_shape=(2, 3),
                  partitioner="cost_balanced", merge="fused_merge"))):
        res, wall_ms, counts, peak = _tick(session(n_axis, **kw))
        ref, _, _, _ = _tick(session(n_axis, k=kw["k"]))
        if counts[kernel] < 1:
            raise AssertionError(f"{label}: {kernel} never launched")
        launches[kernel] = counts[kernel]
        routes = [(kernel, kernel + "_merge")]  # B2's and B3's wide merges
        if kernel == "merge_topk_lists_wide":  # and B1's
            routes.append(("fused_scan_merge_wide",
                           "fused_scan_merge_wide_merge"))
            launches["fused_scan_merge_wide_w256_k384"] = counts[
                "fused_scan_merge_wide"]
        for wide, route in routes:
            if counts[wide] < 1 or counts[route] != counts[wide]:
                raise AssertionError(f"{label}: not every {wide} launch "
                                     f"took {route}")
        bad = _same_lists(res, ref)
        if bad.any():
            raise AssertionError(f"{label}: {int(bad.sum())} rows differ "
                                 "from the single-plan twin")
        report(label, res, wall_ms, counts, peak, twin="bitwise, all rows")
    return launches


def incremental_object_path(dev, n: int, seed: int = 0):
    """``object_sharded`` 4, ``equal``, ``fused_multi`` with
    ``maintenance="incremental"`` beside a ``single`` rebuild twin, at N
    objects, one query per object, every row equal to the twin's:
    the build (``skip``); a 1% move (``incremental``); a move of 30% of one
    shard's owned rows, all inside its Morton range, which is within the
    global budget (0.25 N) but over the shard's (0.25 x owned), so the
    per-shard rule defers it (``rebuild``); a 30% global move, over the
    global budget (``rebuild``)."""
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.core.ticks import shard_churn_over_budget
    from repro_torch.data.generators import make_workload

    spec = ServiceSpec(backend="fused_bucket", plan="object_sharded",
                       mesh_shape=4, partitioner="equal", merge="fused_multi",
                       maintenance="incremental")
    pos = make_workload(n, "uniform", seed=seed + 5, side=spec.side
                        ).positions().copy()
    g = np.random.default_rng(seed + 6)
    session, twin = KnnSession(spec), KnnSession(ServiceSpec(
        backend="fused_bucket"))
    handles = []
    for s in (session, twin):
        s.ingest_objects(pos)
        handles.append(s.register_queries(pos, np.arange(n, dtype=np.int32)))
    owned = -(-n // 4)
    steps = [("build", "skip"), ("move 1%", "incremental"),
             ("one shard's rows", "rebuild"), ("move 30%", "rebuild")]
    for t, (step, want) in enumerate(steps):
        ids = None
        if step == "move 1%":
            ids, new = _move(g, pos, n, 0.01, spec.side)
        elif step == "one shard's rows":
            ids = session.index.ids[: int(0.3 * owned)].cpu().numpy()
            ids, new = _move(g, pos, n, 0.0, spec.side, ids=ids)
        elif step == "move 30%":
            ids, new = _move(g, pos, n, 0.3, spec.side)
        if ids is not None:
            pos[ids] = new
            for s, h in zip((session, twin), handles):
                s.update_objects(ids, new)
                s.update_queries(h, pos)
            in_budget = ids.size <= spec.churn_budget * n
            over = bool(shard_churn_over_budget(
                session.index, torch.tensor(np.sort(ids), device=dev), 4,
                spec.churn_budget, session._obj_bounds))
            rule = {"move 1%": (True, False), "one shard's rows": (True, True),
                    "move 30%": (False, True)}[step]
            if (in_budget, over) != rule:
                raise AssertionError(f"{step}: global in budget {in_budget}, "
                                     f"a shard over budget {over}, want "
                                     f"{rule}")
        res, wall_ms, counts, peak = _tick(session)
        ref, ref_ms, _, _ = _tick(twin)
        if res.maintenance != want:
            raise AssertionError(f"incremental object path tick {t} ({step}): "
                                 f"maintenance {res.maintenance}, want {want}")
        bad = _same_lists(res, ref)
        if bad.any():
            raise AssertionError(f"incremental object path tick {t}: "
                                 f"{int(bad.sum())} rows differ from the "
                                 "single-plan twin")
        if counts["fused_scan_merge"] < 1 or counts["merge_topk_multi"] != 1:
            raise AssertionError(f"incremental object path tick {t}: "
                                 f"launched {counts}")
        print("tick " + json.dumps({
            "path": "incremental object_sharded 4", "tick": t, "step": step,
            "n_objects": n, "moved": 0 if ids is None else int(ids.size),
            "maintenance": res.maintenance, "wall_ms": wall_ms,
            "iterations": res.iterations, "candidates": res.candidates,
            "launches": {k: v for k, v in counts.items() if v},
            "max_memory_allocated": peak, "twin_wall_ms": ref_ms,
            "twin": "bitwise, all rows"}))


def _same_bits(a, b) -> bool:
    """Equal shapes and equal f32 bits."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _sink_reckoning(res, prev, dev):
    """What the stats sink must report for the full lists of ``res`` after
    those of ``prev`` (None: no previous observation): the k-th distances,
    the drift and churn maxima and the one shard's hits, each in f32 as the
    sink computes it; the two means in f64.  The ids each row kept are
    found by a binary search of the row's sorted previous ids, on the card
    (not the sink's pairwise compare)."""
    ii, kth = res.nn_idx, res.nn_dist[:, -1]
    valid = ii >= 0
    n_valid = valid.sum(1)
    if prev is None:
        drift = np.zeros(kth.shape, np.float32)
        churn = np.ones(kth.shape, np.float32)
        n_drift = 0
    else:
        pk = prev.nn_dist[:, -1]
        ok = np.isfinite(kth) & np.isfinite(pk)
        drift = np.where(ok, np.abs(kth - pk), np.float32(0))
        n_drift = int(ok.sum())
        cur = torch.tensor(ii, device=dev)
        old = torch.sort(torch.tensor(prev.nn_idx, device=dev), dim=1).values
        at = torch.searchsorted(old, cur).clamp(max=old.shape[1] - 1)
        kept = ((old.gather(1, at) == cur) & (cur >= 0)).sum(1).cpu().numpy()
        churn = np.float32(1) - kept.astype(np.float32) / np.maximum(
            n_valid, 1).astype(np.float32)
        churn = np.where(n_valid > 0, churn, np.float32(0))
    return {"kth_dist": kth,
            "kth_drift_max": np.float32(max(drift.max(), 0)),
            "churn_max": np.float32(max(churn.max(), 0)),
            "shard_hits": np.array([valid.sum()], np.float32),
            "kth_drift_mean": drift.astype(np.float64).sum() / max(n_drift, 1),
            "churn_mean": churn.astype(np.float64).mean()}


def _four_tenants(server, qpos, qid):
    """Admit four tenants: tenant i registers one query for each object
    ``i::4`` (at ``qpos``, qid = its id), tenant 0 also up to 65,536 rows
    that duplicate tenant 1's.  Returns (tenants, query groups, each
    group's rows)."""
    T = 4
    tenants = [server.admit(f"tenant-{i}") for i in range(T)]
    rows = [qid[i::T] for i in range(T)]
    rows.append(qid[1::T][:65_536])  # tenant 0's duplicates of tenant 1's
    groups = [t.register_queries(qpos[r], r)
              for t, r in zip(tenants, rows[:T])]
    groups.append(tenants[0].register_queries(qpos[rows[T]], rows[T]))
    return tenants, groups, rows


def server_path(dev, n: int, seed: int = 0):
    """The multi-tenant server on the paper's Table 1 world: N uniform
    objects, k = 32, spec defaults, ``fused_bucket``, ``single``,
    ``invalidation="spatial"`` with a cache of 1,048,576 entries.  Tenant i
    registers one query for each object ``i::4`` (at its tick-0 position,
    qid = its id); tenant 0 also registers 65,536 rows that duplicate tenant
    1's.  Ticks: the build (every unique row computed, the duplicates
    folded); an unchanged tick (all from the cache, no device work); tenant
    2 moves 2,000 objects up to 200 u (N / 500; under the stab budget, the
    pyramid stab: only the stabbed entries recomputed); tenant 3 moves 1%
    (over the budget: the epoch clears, every row recomputed).  Every tenant row of
    every tick equals a solo ``collect="full"`` session fed the same world,
    whose 1,024 sampled rows a tick equal the brute-force oracle.  Beside
    them a ``collect="stats"`` session on ticks 0, 2 and 3, whose k-th
    distances, maxima and shard hits equal what the full twin's lists give,
    bitwise (the means within 1e-5 of an f64 sum), at a peak within 10% of
    the twin's.  Returns the server's B1 launches."""
    from repro_torch.api import KnnSession, ServiceSpec
    from repro_torch.data.generators import make_workload
    from repro_torch.serve import KnnServer

    spec = ServiceSpec(backend="fused_bucket")
    pos = make_workload(n, "uniform", seed=seed + 7, side=spec.side
                        ).positions().copy()
    g = np.random.default_rng(seed + 8)
    qid = np.arange(n, dtype=np.int32)
    qpos = pos.copy()  # the queries stay where their objects started
    qpos_t = torch.tensor(qpos, device=dev)
    T = 4
    # the default stab budget at 1M objects, scaled with N, so that a small
    # first-check run takes the same routes
    server = KnnServer(spec, invalidation="spatial", cache_entries=1_048_576,
                       stab_budget=4096 * n // 1_000_000)
    server.ingest_objects(pos)
    tenants, groups, rows = _four_tenants(server, qpos, qid)
    twin = KnnSession(spec)
    stats = KnnSession(ServiceSpec(backend="fused_bucket", collect="stats"))
    for s in (twin, stats):
        s.ingest_objects(pos)
        s.register_queries(qpos, qid)
    print(f"path server: {server.describe()}, N={n}")
    steps = [("build", None, 0), ("unchanged", None, 0),
             ("tenant 2 moves 2,000", 2, n // 500),
             ("tenant 3 moves 1%", 3, n // 100)]
    launches = 0
    prev_full = None
    for t, (step, mover, m) in enumerate(steps):
        # the stab evicts at ingest
        inval0 = server.cache.stats.invalidations
        epoch0 = server.cache.epoch
        if mover is not None:
            ids, new = _move(g, pos, n, 0.0, spec.side,
                             ids=g.choice(n, m, replace=False
                                          ).astype(np.int32))
            pos[ids] = new
            tenants[mover].update_objects(ids, new)
            for s in (twin, stats):
                s.update_objects(ids, new)
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        st = server.submit()
        res = st.result()
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        b1 = counts["fused_scan_merge"]
        launches += b1
        evicted = server.cache.stats.invalidations - inval0
        ref, _, _, twin_peak = _tick(twin)
        for i, (group, r) in enumerate(zip(groups, rows)):
            ii, dd, qq = st.result_for(group)
            bad = (ii != ref.nn_idx[r]).any(1) | (
                dd.view(np.uint32) != ref.nn_dist[r].view(np.uint32)).any(1)
            if bad.any() or not np.array_equal(qq, r):
                raise AssertionError(f"server tick {t}: group {i} differs "
                                     f"from the solo twin on "
                                     f"{int(bad.sum())} rows")
        if ref.nn_idx.shape != (n, spec.k) or not np.isfinite(
                ref.nn_dist).all():
            raise AssertionError(f"server tick {t}: malformed twin result")
        oracle_check(torch.tensor(pos, device=dev),
                     g.choice(n, 1024, replace=False), ref.nn_idx,
                     ref.nn_dist, spec.k, dev, qpos_t=qpos_t)
        dup = rows[T].size
        want = {0: (n, dup, 0), 1: (0, 0, n + dup), 3: (n, dup, 0)}.get(t)
        got = (res.rows_computed, res.dedup_hit_rows, res.cache_hit_rows)
        if res.rows_total != n + dup or res.rows_unique != n or (
                want is not None and got != want):
            raise AssertionError(f"server tick {t}: rows {res.rows_total}, "
                                 f"unique {res.rows_unique}, (computed, "
                                 f"dedup, cache) {got}, want {want}")
        if t == 1 and (res.inner is not None or b1):
            raise AssertionError("server tick 1 was not served wholly from "
                                 f"the cache: B1 launched {b1}")
        if t != 1 and b1 < 1:
            raise AssertionError(f"server tick {t}: B1 never launched")
        if t == 2 and not (0 < res.rows_computed == evicted < n
                           and res.epoch == epoch0
                           and server.cache.last_invalidation
                           == "delta-stab:tenant-2"):
            raise AssertionError(
                f"server tick 2: computed {res.rows_computed} rows, the "
                f"stab evicted {evicted}, epoch {epoch0} -> {res.epoch}, "
                f"{server.cache.last_invalidation}")
        if t == 3 and (res.epoch != epoch0 + 1
                       or server.cache.last_invalidation
                       != "stab-budget:tenant-3"):
            raise AssertionError(f"server tick 3: epoch {epoch0} -> "
                                 f"{res.epoch}, "
                                 f"{server.cache.last_invalidation}")
        print("server " + json.dumps({
            "tick": t, "step": step, "n_objects": n, "tenants": T,
            "rows": res.rows_total, "unique": res.rows_unique,
            "computed": res.rows_computed, "dedup_hits": res.dedup_hit_rows,
            "cache_hits": res.cache_hit_rows, "evicted": evicted,
            "epoch": res.epoch, "invalidation": server.cache.last_invalidation,
            "submit_s": res.submit_s, "drain_s": res.drain_s,
            "assemble_s": res.assemble_s, "wall_s": res.wall_s,
            "iterations": None if res.inner is None else res.inner.iterations,
            "b1_launches": b1, "max_memory_allocated": peak,
            "twin": "bitwise, every tenant row", "oracle_rows": 1024}))
        if t != 1:
            rs, stats_ms, _, stats_peak = _tick(stats)
            want_s = _sink_reckoning(ref, prev_full, dev)
            agg = rs.aggregates
            for f in ("kth_dist", "kth_drift_max", "churn_max",
                      "shard_hits"):
                got_f = rs.kth_dist if f == "kth_dist" else getattr(agg, f)
                if not _same_bits(got_f, want_s[f]):
                    raise AssertionError(f"stats tick {t}: {f} "
                                         f"{got_f} != {want_s[f]}")
            if int(agg.n_live) != n:
                raise AssertionError(f"stats tick {t}: n_live {agg.n_live}")
            for f in ("kth_drift_mean", "churn_mean"):
                if not np.isclose(float(getattr(agg, f)), want_s[f],
                                  rtol=1e-5, atol=0):
                    raise AssertionError(f"stats tick {t}: {f} "
                                         f"{float(getattr(agg, f))} vs "
                                         f"{want_s[f]}")
            if rs.nn_idx is not None or stats_peak > 1.10 * twin_peak:
                raise AssertionError(f"stats tick {t}: peak {stats_peak} "
                                     f"against the full twin's {twin_peak}")
            print("stats " + json.dumps({
                "tick": t, "step": step, "n_objects": n,
                "wall_ms": stats_ms, "collect_s": rs.collect_s,
                "max_memory_allocated": stats_peak,
                "full_twin_max_memory_allocated": twin_peak,
                "peak_ratio": stats_peak / twin_peak,
                "kth_drift_mean": float(agg.kth_drift_mean),
                "kth_drift_max": float(agg.kth_drift_max),
                "churn_mean": float(agg.churn_mean),
                "churn_max": float(agg.churn_max),
                "shard_hits": agg.shard_hits.tolist(),
                "reckoning": "kth, maxima, shard hits bitwise; means "
                             "within 1e-5"}))
        prev_full = ref
    for s in (twin, stats, server.session):
        s.finalize_pending()
    return launches


def entry_point(n: int):
    """``python -m repro_torch.launch.serve knn`` with four tenants, in this
    process, on the card: it must return 0."""
    from repro_torch.launch.serve import main as serve_main

    argv = ["knn", "--objects", str(n), "--ticks", "3", "--tenants", "4"]
    t0 = time.perf_counter()
    rc = serve_main(argv)
    if rc != 0:
        raise AssertionError(f"knn entry point returned {rc}")
    print("entry " + json.dumps({"argv": argv, "rc": rc,
                                 "seconds": time.perf_counter() - t0}))


# the paper's three evaluation families at the Table 1 scale; the skewed
# presets with the reference's defaults spelled out
EVAL_WORLDS = (("network", {}),
               ("zipf", {"zipf_a": 1.6, "clusters": 12}),
               ("hotspot_cluster", {"cluster_frac": 0.75, "clusters": 12}))


def _eval_rows(g, pos, nodes, size: int = 1024):
    """``size`` sampled query rows; with ``nodes`` (the network's node
    positions) half of them, as far as there are, objects that sit exactly
    on a node.  Returns (rows, node-coincident rows among them)."""
    if nodes is None:
        return g.choice(pos.shape[0], size, replace=False), 0
    on = np.isin(pos.view(np.uint64).ravel(), nodes.view(np.uint64).ravel())
    on_rows, off_rows = np.flatnonzero(on), np.flatnonzero(~on)
    take = min(size // 2, on_rows.size)
    rows = np.concatenate([g.choice(on_rows, take, replace=False),
                           g.choice(off_rows, size - take, replace=False)])
    return rows, take


def _cpu_model() -> str:
    """The host CPU's model name where the machine reports one, and its
    core count."""
    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":")[0].strip() in ("model name", "Model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), "")
        except (OSError, subprocess.SubprocessError):
            pass
    return (f"{name or platform.machine() or 'unknown'}, "
            f"{os.cpu_count()} logical cores")


def _check_kdtree(ii, dd, ri, rd, k: int):
    """The reference's rule for the kd-tree (``tests/test_backends.py``):
    distances within rtol 1e-5, atol 1e-3, and the id sets equal where the
    distance is strictly below the k-th."""
    np.testing.assert_allclose(dd, rd, rtol=1e-5, atol=1e-3)
    for r in range(ii.shape[0]):
        kth = rd[r, k - 1]
        want = set(ri[r][rd[r] < kth * (1 - 1e-6)].tolist()) - {-1}
        got = set(ii[r][dd[r] < kth * (1 - 1e-6)].tolist()) - {-1}
        if want != got:
            raise AssertionError(f"kd-tree row {r}: {want} != {got}")


def _run_example(name: str, argv: list) -> dict:
    """``examples_torch/<name>.py``'s ``main(argv)``, in this process; it
    must return 0.  Returns its kernel launches."""
    import importlib.util

    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _zero_counts()
    t0 = time.perf_counter()
    rc = mod.main(argv)
    counts = _read_counts()
    if rc != 0:
        raise AssertionError(f"examples_torch/{name}.py returned {rc}")
    print("example " + json.dumps({"example": name, "argv": argv, "rc": rc,
                                   "seconds": time.perf_counter() - t0,
                                   "b1_launches":
                                       counts["fused_scan_merge"]}))
    return counts


def evaluation(dev, n: int, n_probe: int, card: str, seed: int = 0):
    """The paper's evaluation entry points on the card; returns the engine
    paths' B1 launches and the probe's B2 launches.

    1. Each world of :data:`EVAL_WORLDS` at ``n`` objects through
       ``TickEngine(EngineConfig(backend="fused_bucket")).run(w, ticks=2)``:
       every object moves on each ``advance()``, one query per object.  On
       every tick B1 launches, no chunk reaches ``max_iters`` (a spy on the
       plan's sweep reads the slowest chunk's trips), and 1,024 sampled rows
       equal the brute-force oracle bit for bit; on the network world half
       the sample sits exactly on a node where it can (at least 256 rows on
       tick 1), and a ``dense_topk`` twin equals every row.
    2. The object-axis probe: ``knn_query_batch_chunked`` with
       ``object_sharded`` 4, ``fused_multi``, ``with_aux`` on the zipf world
       at ``n_probe`` objects, ``equal`` and ``cost_balanced``, each equal
       to the ``single`` plan bitwise; straggler gaps printed.
    3. The sequential kd-tree on the host over the network world's tick-0
       positions, queried at that tick's 1,024 rows and held against the
       card's lists by the reference's rule; its queries/s beside the
       card's.
    4. ``examples_torch/quickstart.py`` and ``moving_objects_service.py``
       (1M-scale network world, ``fused_bucket``), each returning 0.
    """
    import warnings

    from repro_torch.core import (KDTree, EngineConfig, TickEngine,
                                  build_index, knn_query_batch_chunked,
                                  straggler_gap)
    from repro_torch.core import plan as plan_mod
    from repro_torch.data import make_workload

    g = np.random.default_rng(seed + 7)
    b1_total = 0
    kd = {}  # the network world's tick 0, for the kd-tree
    trips = []
    sweep = plan_mod._knn_sorted_impl

    def spy(*a, **kw):  # the slowest chunk's trips of each sweep
        out = sweep(*a, **kw)
        trips.append(int(out[2].iterations.max()))
        return out

    plan_mod._knn_sorted_impl = spy
    try:
        for fam, kw in EVAL_WORLDS:
            w = make_workload(n, fam, seed=seed, **kw)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                engine = TickEngine(EngineConfig(backend="fused_bucket"))
                twin = (TickEngine(EngineConfig()) if fam == "network"
                        else None)
            k, max_iters = engine.cfg.k, engine.cfg.max_iters
            nodes = w.net_nodes if fam == "network" else None
            walls = []

            def on_tick(res):
                counts = _read_counts()  # this tick of the engine only
                peak = torch.cuda.max_memory_allocated()
                t = len(walls)
                walls.append(res.wall_s)
                launches = counts["fused_scan_merge"]
                if launches < 1:
                    raise AssertionError(f"{fam} tick {t}: B1 idle")
                slowest = max(trips)
                if slowest >= max_iters:
                    raise AssertionError(f"{fam} tick {t}: a chunk ran "
                                         f"{slowest} trips")
                pos = w.positions()
                if res.nn_idx.shape != (n, k) or not np.isfinite(
                        res.nn_dist).all():
                    raise AssertionError(f"{fam} tick {t}: malformed result")
                rows, on_node = _eval_rows(g, pos, nodes)
                if nodes is not None and t > 0 and on_node < 256:
                    raise AssertionError(f"network tick {t}: only {on_node} "
                                         "sampled rows sit on a node")
                oracle_check(torch.tensor(pos, device=dev), rows, res.nn_idx,
                             res.nn_dist, k, dev)
                rec = {"world": fam, "tick": t, "n_objects": n,
                       "wall_ms": res.wall_s * 1e3,
                       "iterations": res.iterations,
                       "slowest_chunk_trips": slowest,
                       "candidates": res.candidates, "launches": launches,
                       "rebuilt": res.rebuilt,
                       "maintenance": res.maintenance,
                       "max_memory_allocated": peak, "oracle_rows": 1024,
                       "node_rows": on_node, "oracle": "bitwise"}
                if twin is not None:
                    ref = twin.process_tick(pos, *w.query_batch(1.0))
                    bad = _same_lists(res, ref)
                    if bad.any():
                        raise AssertionError(f"network tick {t}: "
                                             f"{int(bad.sum())} rows differ "
                                             "from the dense_topk twin")
                    rec["dense_topk_twin"] = "bitwise, all rows"
                    rec["dense_topk_wall_ms"] = ref.wall_s * 1e3
                if fam == "network" and t == 0:
                    kd.update(pos=pos.copy(), rows=rows,
                              ii=res.nn_idx[rows], dd=res.nn_dist[rows])
                print("eval " + json.dumps(rec))
                nonlocal b1_total
                b1_total += launches
                trips.clear()
                _zero_counts()  # the next tick's counts start here
                torch.cuda.reset_peak_memory_stats()

            trips.clear()
            _zero_counts()
            torch.cuda.reset_peak_memory_stats()
            engine.run(w, ticks=2, on_tick=on_tick)
            if fam == "network":
                kd["card_qps"] = [n / s for s in walls]
            engine.session.finalize_pending()
    finally:
        plan_mod._knn_sorted_impl = sweep

    # the object-axis probe (study S7's straggler measurement)
    w = make_workload(n_probe, "zipf", seed=seed, zipf_a=1.6, clusters=12)
    pos = w.positions()
    qid = np.arange(n_probe, dtype=np.int32)
    index = build_index(torch.tensor(pos, device=dev), (0.0, 0.0), 22_500.0,
                        l_max=8, th_quad=192)
    kw = dict(k=32, window=256, chunk=8192, backend="fused_bucket")
    ii, dd, st = knn_query_batch_chunked(index, pos, qid, **kw)
    b2_total = 0
    for part in ("equal", "cost_balanced"):
        _zero_counts()
        t0 = time.perf_counter()
        oi, od, ost, aux = knn_query_batch_chunked(
            index, pos, qid, plan="object_sharded", num_devices=4,
            merge="fused_multi", partitioner=part, with_aux=True, **kw)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        if counts["fused_scan_merge"] < 1 or counts["merge_topk_multi"] != 1:
            raise AssertionError(f"probe {part}: launched {counts}")
        bad = (oi != ii).any(1) | (od.view(np.uint32)
                                   != dd.view(np.uint32)).any(1)
        if bad.any():
            raise AssertionError(f"probe {part}: {int(bad.sum())} rows "
                                 "differ from the single plan")
        sc = aux.shard_candidates
        if _fold_f32(sc) != np.float32(ost.candidates):
            raise AssertionError(f"probe {part}: shard candidates "
                                 f"{sc.tolist()} do not sum to "
                                 f"{ost.candidates}")
        b2_total += counts["merge_topk_multi"]
        print("probe " + json.dumps({
            "world": "zipf", "n_objects": n_probe, "partitioner": part,
            "wall_ms": wall_ms, "iterations": ost.iterations,
            "single_iterations": st.iterations,
            "shard_candidates": sc.tolist(),
            "shard_iterations": aux.shard_iterations.tolist(),
            "object_bounds": aux.object_bounds.tolist(),
            "straggler_gap": straggler_gap(sc),
            "b1_launches": counts["fused_scan_merge"],
            "b2_launches": counts["merge_topk_multi"],
            "single_twin": "bitwise, all rows"}))
    del index

    # the sequential competitor of study S3, on the host
    pos0, rows = kd["pos"], kd["rows"]
    t0 = time.perf_counter()
    tree = KDTree(pos0)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ri, rd = tree.query_batch(pos0[rows], 32, qid=rows)
    query_s = time.perf_counter() - t0
    _check_kdtree(kd["ii"], kd["dd"], ri, rd, 32)
    print("kdtree " + json.dumps({
        "n_objects": n, "rows": int(rows.size), "build_s": build_s,
        "query_s": query_s, "host_queries_per_s": rows.size / query_s,
        "card_tick_queries_per_s": kd["card_qps"], "cpu": _cpu_model(),
        "card": card, "rule": "reference: allclose, id sets below kth"}))

    _run_example("quickstart", ["--device", "cuda"])
    counts = _run_example("moving_objects_service", [
        "--objects", str(n), "--ticks", "3", "--backend", "fused_bucket",
        "--distribution", "network"])
    if counts["fused_scan_merge"] < 1:
        raise AssertionError("the service example did not launch B1")
    return b1_total, b2_total


# the properties phase's kernel merges
PROPERTY_MERGES = ("fused_multi", "fused_merge")


def _property_draw(name: str, draw, run):
    """Print one drawn example, run it, print its result line."""
    print("properties draw " + json.dumps({"property": name, "draw": draw}),
          flush=True)
    t0 = time.perf_counter()
    cells = run()
    print("properties " + json.dumps({
        "property": name, "draw": draw, "cells": cells, "equal": True,
        "seconds": time.perf_counter() - t0}), flush=True)


def properties_reference_shapes(dev):
    """Part A: the reference's property harness (``repro_torch.properties``)
    on the card at its own shapes, with its draws (``repro_torch.testing``,
    seeded by each property's name).  At these shapes a tick is host-bound
    (0.5 to 0.95 s on an H100 at 128 objects), so the part puts the
    draws through the card's kernels and leaves the plain backends' grids
    to the CPU tests:
    - every draw of the full and mixed matrices with the grid through
      ``fused_bucket`` (every backend's ``single`` lists cross-checked on
      each full draw), the kernel merges alternating draw by draw on the
      object-axis plans; each drawn cloud's ``fused_bucket`` ``single``
      lists equal the brute-force oracle on the card, bit for bit;
    - every n < k draw, ``fused_bucket`` with both kernel merges (the
      sentinel-only object shards);
    - the first maintenance draw on ``hybrid`` (2, 2) ``equal`` with
      ``fused_merge``, and the first server draw on ``object_sharded`` 4
      ``cost_balanced`` with ``fused_multi``;
    - the pinned mover (``object_sharded`` 4 ``cost_balanced``,
      ``fused_multi``) and the R-way composition (both kernel merges).
    Returns the part's kernel launches."""
    from repro_torch import properties as P
    from repro_torch.testing import draws

    fused = ("fused_bucket",)
    # the maintenance and server draws' cells: the mover holds incremental
    # object_sharded with fused_multi
    hybrid = (("hybrid", P.PLAN_GRID[-1][1], "equal"),)
    sharded = (("object_sharded", P.NDEV, "cost_balanced"),)

    def matrix(fn, draw, i):  # the kernel merges alternate draw by draw
        pts, qpos, qid, singles, cells = fn(
            *draw, device=dev, backends=fused,
            merges=(PROPERTY_MERGES[i % 2],))
        oracle_check(torch.tensor(pts, device=dev), np.arange(len(qpos)),
                     *singles["fused_bucket"], 6, dev,
                     qpos_t=torch.tensor(qpos, device=dev), qid=qid)
        return cells

    # property -> (draws run on the card, None: all; run(draw, index))
    plan = {
        "test_full_matrix_bit_identical": (
            None, lambda d, i: matrix(P.full_matrix, d, i)),
        "test_mixed_precision_bit_identical": (
            None, lambda d, i: matrix(P.mixed_matrix, d, i)),
        "test_fewer_objects_than_k_all_plans": (
            None, lambda d, i: P.fewer_objects_than_k(
                *d, device=dev, backends=fused, merges=PROPERTY_MERGES)[-1]),
        "test_maintenance_axis_bit_identical": (
            1, lambda d, i: P.maintenance_axis(
                *d, device=dev, backend="fused_bucket",
                merges=("fused_merge",), grid=hybrid)),
        "test_server_axis_bit_identical": (
            1, lambda d, i: P.server_axis(
                *d, device=dev, backend="fused_bucket",
                merges=("fused_multi",), grid=sharded)),
    }
    _zero_counts()
    for name, (strats, n) in P.PROPERTIES.items():
        count, run = plan[name]
        for i, draw in enumerate(draws(name, strats, n)[:count]):
            _property_draw(name, {"values": list(draw), "index": i},
                           lambda: run(draw, i))
    _property_draw("test_mover_crosses_moving_cost_balanced_boundary",
                   {"merge": "fused_multi"},
                   lambda: P.mover_crosses_boundary(
                       device=dev, backend="fused_bucket",
                       merge="fused_multi"))
    for r in (2, 3, 8):
        _property_draw("test_pipeline_r_way_partition_composes",
                       {"r": r, "merges": PROPERTY_MERGES},
                       lambda: sum(P.r_way_partition(
                           r, device=dev, backend="fused_bucket", merge=m)
                           for m in PROPERTY_MERGES))
    torch.cuda.synchronize()
    counts = _read_counts()
    for name in ("fused_scan_merge", "fused_scan_merge_mixed",
                 "merge_topk_multi", "merge_topk_lists"):
        if counts[name] < 1:
            raise AssertionError(f"properties part A: {name} never launched")
    return counts


def properties_full_width(dev, n: int, n_axis: int):
    """Part B: two of the harness's clouds at ``n`` objects with its
    duplicate overlay (``dup_every`` drawn from 2 to 6): the ``zipf``
    world as the evaluation phase runs it (``zipf_a`` 1.6, 12 clusters, the
    generator's own sigma) and the gaussian-hotspot family.  Spec defaults,
    one query per object: ``fused_bucket`` fp32, ``mixed`` and a
    ``dense_topk`` twin equal on every row; 1,024 sampled rows, each with a
    coincident duplicate, equal to the oracle; then, on the gaussian draw,
    ``object_sharded`` 4 ``fused_multi`` at ``n_axis`` objects equal to
    the ``single`` plan on every row (the evaluation phase's probe holds
    zipf there).  Returns the part's kernel launches."""
    from repro_torch import properties as P
    from repro_torch.core import build_index, knn_query_batch_chunked
    from repro_torch.testing import draws, strategies as st

    kw = dict(k=32, window=256, chunk=8192, device=dev)
    total = dict.fromkeys(_counters(), 0)
    worlds = (("zipf", 2, {"clusters": 12}), ("gaussian", 1, None))
    picks = draws("properties_full_width",
                  (st.integers(0, 10_000), st.integers(2, 6)), len(worlds))
    for (world, family, zkw), (cseed, dup) in zip(worlds, picks):
        draw = {"world": world, "seed": cseed, "dup_every": dup, "n": n}
        print("properties draw " + json.dumps({"property": "full_width",
                                                "draw": draw}), flush=True)
        pts = P.cloud(cseed, n, family, dup, 1.6, zipf_kw=zkw)
        qid = np.arange(n, dtype=np.int32)
        index = build_index(torch.tensor(pts, device=dev), (0.0, 0.0),
                            P.SIDE, l_max=8, th_quad=192)
        out, walls, launches = {}, {}, {}
        for label, extra in (("fp32", {"backend": "fused_bucket"}),
                             ("mixed", {"backend": "fused_bucket",
                                        "precision": "mixed"}),
                             ("dense_topk", {"backend": "dense_topk"})):
            _zero_counts()
            t0 = time.perf_counter()
            ii, dd, st_ = knn_query_batch_chunked(index, pts, qid, **kw,
                                                  **extra)
            walls[label] = (time.perf_counter() - t0) * 1e3
            counts = _read_counts()
            for name, c in counts.items():
                total[name] += c
            launches[label] = {"b1": counts["fused_scan_merge"],
                               "b1_mixed": counts["fused_scan_merge_mixed"]}
            out[label] = (ii, dd, st_.iterations)
        ref = out["fp32"]
        if ref[0].shape != (n, 32) or not np.isfinite(ref[1]).all():
            raise AssertionError(f"{world}: malformed result")
        for label in ("mixed", "dense_topk"):
            got = out[label]
            bad = (got[0] != ref[0]).any(1) | (
                got[1].view(np.uint32) != ref[1].view(np.uint32)).any(1)
            if bad.any():
                raise AssertionError(f"{world}: {label} differs from fp32 on "
                                     f"{int(bad.sum())} rows")
        if launches["fp32"]["b1"] < 1 or launches["mixed"]["b1_mixed"] < 1:
            raise AssertionError(f"{world}: B1 idle {launches}")
        # the sample: rows whose position another object shares
        _, inv, cnt = np.unique(pts.view(np.uint64).ravel(),
                                return_inverse=True, return_counts=True)
        g = np.random.default_rng(cseed + 1)
        rows = g.choice(n, 1024, replace=False)
        dup_rows = int((cnt[inv[rows]] > 1).sum())
        if dup_rows < 512:
            raise AssertionError(f"{world}: {dup_rows} sampled rows have a "
                                 "coincident duplicate")
        oracle_check(torch.tensor(pts, device=dev), rows, ref[0], ref[1], 32,
                     dev)
        del index
        rec = {"property": "full_width", "draw": draw, "equal": True,
               "wall_ms": walls,
               "iterations": {k_: v[2] for k_, v in out.items()},
               "launches": launches, "oracle_rows": 1024,
               "duplicate_rows": dup_rows}
        if world != "gaussian":
            print("properties " + json.dumps(rec), flush=True)
            continue

        # the object axis at n_axis objects of the same draw
        pts_a = P.cloud(cseed, n_axis, family, dup, 1.6, zipf_kw=zkw)
        qid_a = np.arange(n_axis, dtype=np.int32)
        index = build_index(torch.tensor(pts_a, device=dev), (0.0, 0.0),
                            P.SIDE, l_max=8, th_quad=192)
        si, sd, _ = knn_query_batch_chunked(index, pts_a, qid_a, **kw,
                                            backend="fused_bucket")
        _zero_counts()
        t0 = time.perf_counter()
        oi, od, ost = knn_query_batch_chunked(
            index, pts_a, qid_a, **kw, backend="fused_bucket",
            plan="object_sharded", num_devices=4, merge="fused_multi")
        axis_ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        for name, c in counts.items():
            total[name] += c
        bad = (oi != si).any(1) | (od.view(np.uint32)
                                   != sd.view(np.uint32)).any(1)
        if bad.any() or counts["merge_topk_multi"] != 1:
            raise AssertionError(f"{world} object_sharded: {int(bad.sum())} "
                                 f"rows differ; launches {counts}")
        del index
        rec.update(object_sharded_n=n_axis, object_sharded_ms=axis_ms,
                   object_sharded_iterations=ost.iterations,
                   object_sharded_b1=counts["fused_scan_merge"],
                   object_sharded_b2=counts["merge_topk_multi"])
        print("properties " + json.dumps(rec), flush=True)
    return total


def properties_kernel_api(dev, q_max: int = 4096, c_max: int = 40_000):
    """Part C: the kernel API on drawn shapes (``repro_torch.testing``'s
    strategies under a fixed seed), six draws of Q from 1 to ``q_max``, C
    from 1 to ``c_max``, k from 1 to 600 and R from 2 to 8, and one more
    with C < k.
    B1 (fp32 and mixed) on :func:`kernel_inputs`' rows (the NaN, negative,
    duplicate and unsorted bands), B2 and B3 on :func:`merge_inputs`'
    ascending lists (ties and duplicates across lists, empty and
    (inf, id)-padded lists), B4 on :func:`topk_inputs`' rows with
    :func:`odd_values`' bands, B5 and B6 on :func:`window_inputs`' (a NaN
    band, negative coordinates): each through its ``*_op`` wrapper,
    the narrow or the wide template as the shape falls, held against its
    plain version by :func:`same_values`, B5 also by its guarantee.
    Returns the number of shapes each kernel was held on."""
    from repro_torch.kernels import bucket_kselect as bk
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels.refine import masked_argmin_rounds
    from repro_torch.testing import draws, strategies as st

    shape = (st.integers(1, q_max), st.integers(1, c_max),
             st.integers(1, 600), st.integers(2, 8))
    shapes = draws("properties_kernel_api", shape, 6)
    # one more draw with fewer candidates than k
    q, _, k, r = draws("properties_kernel_api_c_below_k", shape, 1)[0]
    shapes.append((q, int(np.random.default_rng(k).integers(1, max(2, k))),
                   k, r))
    held = {}

    def check(name, out, want, seed_shape):
        if not (same_values(out[0], want[0]) and torch.equal(out[1],
                                                             want[1])):
            raise AssertionError(f"{name} != plain version at {seed_shape}")
        held[name] = held.get(name, 0) + 1

    for i, (q, c, k, r) in enumerate(shapes):
        tag = {"Q": q, "C": c, "k": k, "R": r}
        print("properties draw " + json.dumps({"property": "kernel_api",
                                                "draw": tag}), flush=True)
        t0 = time.perf_counter()
        # B1, fp32 and mixed: a window of W = C entries per row
        args = kernel_inputs(q, c, k, dev, seed=i)
        for precision in ("fp32", "mixed"):
            out = ops.fused_scan_merge_op(
                torch.stack(args[:2], 1), torch.stack(args[2:4], 2),
                *args[4:], k=k, precision=precision)
            want = fs.fused_scan_merge_ref(*args, k=k, precision=precision)
            check("fused_scan_merge" + ("_mixed" if precision == "mixed"
                                        else ""), out, want, tag)
        del args
        # B2: R ascending lists of k; B3: ascending lists of ka <= k and k
        d, ids = merge_inputs(r, q, k, dev, seed=i, inf_ids=True)
        out = ops.multi_merge_lists_op(d, ids, k=k)
        cat = lambda t: t.transpose(0, 1).reshape(q, r * k).contiguous()
        check("merge_topk_multi", out,
              mt.merge_topk_multi_ref(cat(d), cat(ids), k=k), tag)
        ka = int(np.random.default_rng(i).integers(1, k + 1))
        lists = (d[0, :, :ka].contiguous(), ids[0, :, :ka].contiguous(),
                 d[1].contiguous(), ids[1].contiguous())
        check("merge_topk_lists", ops.merge_topk_lists_op(*lists, k=k),
              mt.merge_topk_lists_ref(*lists, k=k), tag)
        del d, ids, lists
        # B4
        d, ids = topk_inputs(q, c, k, dev, seed=i)
        d = odd_values(d)
        check("topk_select", ops.topk_select_op(d, ids, k=k),
              masked_argmin_rounds(d, ids, k), tag)
        del d, ids
        # B5 and B6: one shared window of C
        qpos, ppos, valid = window_inputs(q, c, dev, seed=i)
        qx, qy = qpos[:, 0].contiguous(), qpos[:, 1].contiguous()
        px, py = ppos[:, 0].contiguous(), ppos[:, 1].contiguous()
        d2 = pd.pairwise_dist_ref(qx, qy, px, py, valid)
        if not same_values(ops.pairwise_dist_op(qpos, ppos, valid), d2):
            raise AssertionError(f"pairwise_dist != plain version at {tag}")
        held["pairwise_dist"] = held.get("pairwise_dist", 0) + 1
        rad = ops.bucket_kselect_op(qpos, ppos, valid, k=k)
        if not same_values(rad, bk.bucket_kselect_ref(qx, qy, px, py, valid,
                                                      k=k)):
            raise AssertionError(f"bucket_kselect != plain version at {tag}")
        if not _guarantee(d2, rad, k, int(valid.sum())):
            raise AssertionError(f"bucket_kselect: the guarantee fails at "
                                 f"{tag}")
        held["bucket_kselect"] = held.get("bucket_kselect", 0) + 1
        del d2, qpos, ppos, valid
        torch.cuda.synchronize()
        print("properties " + json.dumps({
            "property": "kernel_api", "draw": tag, "equal": True,
            "kernels": sorted(held), "seconds": time.perf_counter() - t0}),
            flush=True)
    return held


def properties(dev, n: int, n_axis: int, short: bool = False):
    """The properties phase: Parts A, B and C (Part C at an eighth of its
    widths with ``short``).  Returns the launches of B1, B1 mixed, B2 and
    B3 in Parts A and B, and the shapes Part C held each kernel on."""
    t0 = time.perf_counter()
    counts_a = properties_reference_shapes(dev)
    t_a = time.perf_counter() - t0
    counts_b = properties_full_width(dev, n, n_axis)
    t_b = time.perf_counter() - t0 - t_a
    held = (properties_kernel_api(dev, q_max=512, c_max=5000) if short
            else properties_kernel_api(dev))
    names = ("fused_scan_merge", "fused_scan_merge_mixed",
             "merge_topk_multi", "merge_topk_lists")
    launches = {name: {"reference_shapes": counts_a[name],
                       "full_width": counts_b[name]} for name in names}
    print("properties " + json.dumps({
        "property": "summary", "seconds": {
            "reference_shapes": t_a, "full_width": t_b,
            "kernel_api": time.perf_counter() - t0 - t_a - t_b},
        "launches": launches, "kernel_api_shapes": held}), flush=True)
    return launches, held


# the lm phase: prompt, batch and decode steps of every run; the layers
# each architecture keeps on one card (the rest at full depth)
LM_PROMPT, LM_BATCH, LM_TOKENS = 128, 4, 16
LM_ENTRY_ARCH = "rwkv6_3b"
LM_DEPTHS = {"deepseek_coder_33b": 16, "yi_34b": 16, "nemotron_4_340b": 2,
             "qwen3_moe_235b_a22b": 4}
# the card's float32 against the CPU port's, as the CPU tests hold the port
# against the reference (rwkv6's group norm amplifies rounding)
LM_TOL = {"default": (1e-4, 1e-5), "rwkv6_3b": (1e-4, 1e-4)}
LM_CHECK_STEPS = 4


def _lm_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _lm_flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _lm_flat(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _lm_drive(cfg, params, inp, dev) -> dict:
    """forward (full and last-only), the seeded decode state and
    ``LM_CHECK_STEPS`` teacher-forced decode steps on ``dev``: {name: f64
    numpy}."""
    from repro_torch import models as M

    def host(t):
        return t.detach().double().cpu().numpy()

    b, s = inp["tokens"].shape
    t = {k: torch.tensor(v, device=dev) for k, v in inp.items()}
    out = {}
    with torch.inference_mode():
        logits, aux = M.forward(params, cfg, t)
        out["forward/logits"], out["forward/aux"] = host(logits), host(aux)
        out["last/logits"] = host(M.forward(params, cfg, t,
                                            logits_last_only=True)[0])
        state = M.init_decode_state(cfg, b, s + LM_CHECK_STEPS, mem_len=s,
                                    device=dev)
        if cfg.family == "encdec":
            state = M.seed_decode_state(params, cfg, state, M.encode_memory(
                params, cfg, t["frames"]))
        elif cfg.family == "vlm":
            state = M.seed_decode_state(params, cfg, state, t["img"])
        for i in range(LM_CHECK_STEPS):
            logits, state = M.decode_step(params, cfg, state,
                                          t["steps"][i], s + i)
            out[f"step{i}/logits"] = host(logits)
            out.update({f"step{i}/state{k}": host(v)
                        for k, v in _lm_flat(state).items()})
    return out


def lm_card_vs_cpu(dev, card: str):
    """Each smoke config in float32 (``highest`` matmul precision, no TF32)
    on the card against the CPU port on the same weights: the port's own
    init from a seed, every constant leaf moved by seeded noise so that no
    path is silenced, carried to both devices by ``params_from_numpy``;
    forward, the seeded state and four teacher-forced decode steps, within
    ``LM_TOL``."""
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params

    torch.set_float32_matmul_precision("highest")
    rows = []
    for i, arch in enumerate(list_archs()):
        cfg = get_smoke_config(arch)
        g = np.random.default_rng(300 + i)

        def nudge(tree):
            if isinstance(tree, dict):
                return {k: nudge(v) for k, v in tree.items()}
            if tree.size and np.all(tree == tree.flat[0]):
                return (tree + g.normal(0, 0.2, tree.shape)).astype(
                    np.float32)
            return tree

        tree = nudge(params_to_numpy(init_params(
            cfg, torch.Generator().manual_seed(i), device="cpu")))
        b, s = 2, 16
        inp = {"tokens": g.integers(0, cfg.vocab, (b, s)),
               "steps": g.integers(0, cfg.vocab, (LM_CHECK_STEPS, b, 1))}
        if cfg.family == "encdec":
            inp["frames"] = g.normal(0, 0.5, (b, s, cfg.d_model)).astype(
                np.float32)
        if cfg.family == "vlm":
            inp["img"] = g.normal(0, 0.5, (b, cfg.n_img_tokens,
                                           cfg.d_model)).astype(np.float32)
        t0 = time.perf_counter()
        want = _lm_drive(cfg, params_from_numpy(tree, cfg, device="cpu"),
                         inp, torch.device("cpu"))
        got = _lm_drive(cfg, params_from_numpy(tree, cfg, device=dev), inp,
                        dev)
        rtol, atol = LM_TOL.get(arch, LM_TOL["default"])
        err = 0.0
        for key, w in want.items():
            if got[key].shape != w.shape or not np.allclose(
                    got[key], w, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"lm {arch} {key}: the card differs from the CPU by "
                    f"{np.abs(got[key] - w).max()} (rtol {rtol}, atol "
                    f"{atol})")
            err = max(err, float(np.abs(got[key] - w).max()))
        rows.append({"arch": arch, "outputs": len(want), "max_abs_err": err,
                     "rtol": rtol, "atol": atol,
                     "seconds": time.perf_counter() - t0})
    print("lm " + json.dumps({"run": "card against cpu, smoke configs, f32",
                              "configs": rows, "card": card}), flush=True)


# the full-width check: the layers each family keeps (enough for every
# block kind: the hybrid's group, shared attention and trailing block, the
# vlm's group of self and cross layers); bf16 is held by the relative L2
# error of each output (bf16 rounds to 2^-9; 0.011 to 0.018 at the smoke
# widths; a wrong index, mask or head map gives O(1)), since a pointwise
# bound is a test of the tail over 33M logits; rwkv6 is held in float32
# against the CPU
LM_WIDE_DEPTHS = {"dense": dict(n_layers=2), "moe": dict(n_layers=2),
                  "ssm": dict(n_layers=2), "hybrid": dict(n_layers=8),
                  "encdec": dict(n_layers=2, n_enc_layers=1, n_dec_layers=1),
                  "vlm": dict(n_layers=5)}
LM_WIDE_ARCH_DEPTHS = {"nemotron_4_340b": dict(n_layers=1)}
LM_BF16_REL = 0.05
LM_WIDE_F32_CPU = ("rwkv6_3b",)


def _lm_tree_map(fn, tree, spec):
    """``tree`` with each leaf replaced, in place, by ``fn(leaf, spec leaf)``
    (one leaf at a time, so a cast never holds two whole trees)."""
    for k in tree:
        if isinstance(tree[k], dict):
            _lm_tree_map(fn, tree[k], spec[k])
        else:
            tree[k] = fn(tree[k], spec[k])
    return tree


def _lm_routes(mode: str, routes: list):
    """A stand-in for the router's top-k that records its experts
    (``mode="record"``) into ``routes``, or takes them from there in order
    (``"replay"``), each run's own probabilities gathered at them."""
    from repro_torch.models import moe

    real = moe._top_k
    step = iter(range(len(routes))) if mode == "replay" else None

    def top_k(probs, k):
        if step is None:
            vals, idx = real(probs, k)
            routes.append(idx)
            return vals, idx
        idx = routes[next(step)]
        return torch.gather(probs, -1, idx), idx

    return top_k


def lm_full_width(dev, card: str):
    """Every architecture at full width, cut to ``LM_WIDE_DEPTHS``, on a
    prompt of ``LM_PROMPT`` and a batch of 1: forward (full and last-only)
    and ``LM_CHECK_STEPS`` teacher-forced decode steps, every logit (and the
    MoE aux loss) held, so that the full-width shapes (head_dim 128, the GQA
    ratios, the 256K vocabularies, the real expert counts) meet a check
    beyond finiteness:
    - the card's bf16 run against its float32 run (``highest`` matmul
      precision) of the same weights, the f32 ones being the bf16 values,
      each output's relative L2 error within ``LM_BF16_REL``; the MoE's bf16 run takes the experts its f32
      run chose (a near-tie of the router resolves by the rounding, and
      a token sent to another expert is not an error of precision);
    - ``LM_WIDE_F32_CPU``: the card's float32 run against the CPU port's on
      the same weights within ``LM_TOL``.  RWKV6's per-head group norm
      normalises a sum that cancels to near zero at this init, so its bf16
      logits are no stable function of its inputs and cannot be held
      pointwise against f32."""
    import dataclasses

    from repro_torch.configs import get_config, list_archs
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params, moe

    torch.set_float32_matmul_precision("highest")
    cpu = torch.device("cpu")
    rows = []
    for i, arch in enumerate(list_archs()):
        full = get_config(arch)
        cut = LM_WIDE_ARCH_DEPTHS.get(arch, LM_WIDE_DEPTHS[full.family])
        cfg = dataclasses.replace(full, **cut)
        f32 = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
        g = np.random.default_rng(500 + i)
        inp = {"tokens": g.integers(0, cfg.vocab, (1, LM_PROMPT)),
               "steps": g.integers(0, cfg.vocab, (LM_CHECK_STEPS, 1, 1))}
        if cfg.family == "encdec":
            inp["frames"] = g.normal(0, 0.5, (1, LM_PROMPT, cfg.d_model)
                                     ).astype(np.float32)
        if cfg.family == "vlm":
            inp["img"] = g.normal(0, 0.5, (1, cfg.n_img_tokens, cfg.d_model)
                                  ).astype(np.float32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_params(f32, torch.Generator(device=dev).manual_seed(i),
                             device=dev)
        if arch in LM_WIDE_F32_CPU:
            against = "f32 on the cpu"
            rtol, atol = LM_TOL.get(arch, LM_TOL["default"])
            want = _lm_drive(f32, params_from_numpy(
                params_to_numpy(params), f32, device=cpu), inp, cpu)
            got = _lm_drive(f32, params, inp, dev)
        else:
            against = "bf16 against f32 on the card"
            rtol, atol = None, None
            spec = init_params(cfg, device="meta")
            # the f32 weights take the bf16 values the bf16 run will hold
            _lm_tree_map(lambda t, s: t.copy_(t.to(s.dtype)) if s.dtype
                         == torch.bfloat16 else t, params, spec)
            routes, real = [], moe._top_k
            try:
                moe._top_k = _lm_routes("record", routes)
                want = _lm_drive(f32, params, inp, dev)
                params = _lm_tree_map(lambda t, s: t.to(s.dtype), params,
                                      spec)
                moe._top_k = _lm_routes("replay", routes)
                got = _lm_drive(cfg, params, inp, dev)
            finally:
                moe._top_k = real
        del params
        err, rel = 0.0, 0.0
        for key, w in want.items():
            if "/state" in key:
                continue
            if got[key].shape != w.shape or not np.all(np.isfinite(got[key])):
                raise AssertionError(f"lm {arch} at full width: {key} has "
                                     "the wrong shape or is not finite")
            d = np.abs(got[key] - w)
            r = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30))
            if (r > LM_BF16_REL if rtol is None
                    else np.any(d > atol + rtol * np.abs(w))):
                raise AssertionError(
                    f"lm {arch} at full width ({against}): {key} differs by "
                    f"{d.max()}, relative L2 {r} (rtol {rtol}, atol {atol}, "
                    f"relative L2 bound {LM_BF16_REL} for bf16)")
            err, rel = max(err, float(d.max())), max(rel, r)
        rows.append({"arch": arch, "cut": cut, "n_params": cfg.n_params(),
                     "held": against, "rtol": rtol, "atol": atol,
                     "rel_l2_bound": None if rtol else LM_BF16_REL,
                     "max_abs_err": err, "max_rel_l2_err": rel,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    print("lm " + json.dumps({
        "run": "full width, cut in depth", "prompt": LM_PROMPT, "batch": 1,
        "steps": LM_CHECK_STEPS, "configs": rows, "card": card}), flush=True)


def lm_phase(dev, card: str):
    """The LM harness's serving path on the card: ``serve lm`` at full width
    and depth (``LM_ENTRY_ARCH``, its default), the nine other
    architectures at full width in bf16 through the same ``run_lm``, depth
    cut to ``LM_DEPTHS`` where one card forces it, every logit finite; then
    :func:`lm_full_width` and :func:`lm_card_vs_cpu`.  An ``lm`` line
    each."""
    import dataclasses
    import re

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.serve import run_lm

    torch.cuda.empty_cache()
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
            LM_ENTRY_ARCH, "--prompt-len", str(LM_PROMPT), "--batch",
            str(LM_BATCH), "--tokens", str(LM_TOKENS)]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = _join([subprocess.Popen(argv, env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)],
                "serve lm")[0]
    pattern = (r"prefill \d+x\d+: ([0-9.]+)s.*?: ([0-9.]+) ms/token, "
               r"([0-9.]+) tok/s.*?peak device memory: (\d+) bytes.*?sample:")
    m = re.search(pattern, log, re.S)
    if m is None:
        raise AssertionError(f"serve lm: unexpected output\n{log[-4000:]}")
    cfg = get_config(LM_ENTRY_ARCH)
    print("lm " + json.dumps({
        "run": "serve lm", "argv": argv[3:], "arch": LM_ENTRY_ARCH,
        "family": cfg.family, "layers": cfg.n_layers, "cut": None,
        "n_params": cfg.n_params(), "prefill_s": float(m.group(1)),
        "ms_per_token": float(m.group(2)), "tok_per_s": float(m.group(3)),
        "peak_bytes": int(m.group(4)), "seconds": time.perf_counter() - t0,
        "card": card}), flush=True)
    for arch in list_archs():
        if arch == LM_ENTRY_ARCH:
            continue
        cfg = get_config(arch)
        depth = LM_DEPTHS.get(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        t0 = time.perf_counter()
        r = run_lm(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                   tokens=LM_TOKENS, seed=0, device=dev)
        if not r["finite"]:
            raise AssertionError(f"lm {arch}: a logit is not finite")
        print("lm " + json.dumps({
            "run": "run_lm", "arch": arch, "family": cfg.family,
            "layers": cfg.n_layers,
            "cut": None if depth is None else
            f"n_layers {get_config(arch).n_layers} -> {depth}",
            "n_params": cfg.n_params(), "dtype": cfg.param_dtype,
            "prompt": LM_PROMPT, "batch": LM_BATCH, "tokens": LM_TOKENS,
            **{k: r[k] for k in ("prefill_s", "ms_per_token", "tok_per_s",
                                 "peak_bytes")},
            "seconds": time.perf_counter() - t0, "card": card}), flush=True)
        del r
        torch.cuda.empty_cache()
    lm_full_width(dev, card)
    lm_card_vs_cpu(dev, card)


# the train phase: the entry point at full width and depth, its step count;
# the crash/resume run (smoke width); the families held card against CPU;
# the rank runs' width.  Tolerances are the CPU tests'
# (tests/test_torch_train.py): each gradient leaf within TRAIN_GRAD_TOL of
# its largest element (rwkv6's group norm amplifies rounding), the loss and
# grad norm within TRAIN_CURVE_RTOL
TRAIN_ARCH, TRAIN_STEPS = "rwkv6_3b", 8
TRAIN_SMOKE = ["--arch", "yi_34b", "--smoke", "--steps", "10", "--batch", "4",
               "--seq", "16", "--ckpt-every", "5", "--log-every", "100"]
TRAIN_FAMILIES = ("yi_34b", "granite_moe_3b_a800m", "rwkv6_3b", "zamba2_7b",
                  "seamless_m4t_large_v2", "llama_3_2_vision_11b")
TRAIN_GRAD_TOL = {"default": 2e-5, "rwkv6_3b": 5e-4}
TRAIN_CURVE_RTOL = 2e-5
TRAIN_XPOD_STEPS = 2
TRAIN_DP = ["--arch", "yi_34b", "--smoke", "--steps", "4", "--batch", "8",
            "--seq", "16", "--log-every", "100"]


def _train_metrics(path: Path) -> tuple[list, dict]:
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return lines[:-1], lines[-1]


def train_full_width(card: str) -> float:
    """``python -m repro_torch.launch.train --arch rwkv6_3b`` at full width
    and depth (bf16, ``remat``, the launcher's batch 8 x 128), for
    ``TRAIN_STEPS`` steps, no checkpoint: every loss and grad norm finite,
    every leaf that was not constant at the start moved (a bf16 norm scale
    at 1.0 stays put under steps below half its ulp).  A ``train`` line; returns its seconds."""
    import tempfile

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "metrics.jsonl"
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--metrics",
                str(path)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        log = _join([subprocess.Popen(argv, env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)],
                    "train full width")[0]
        steps, summary = _train_metrics(path)
    if len(steps) != TRAIN_STEPS or "[train] done" not in log:
        raise AssertionError(f"train {TRAIN_ARCH}: {len(steps)} steps\n"
                             f"{log[-4000:]}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"train {TRAIN_ARCH}: step {s['step']} "
                                 f"loss {s['loss']} grad norm "
                                 f"{s['grad_norm']}")
    if summary["random_leaves_moved"] != summary["random_leaves"]:
        raise AssertionError(f"train {TRAIN_ARCH}: "
                             f"{summary['random_leaves_moved']} of "
                             f"{summary['random_leaves']} leaves not constant "
                             "at the start moved")
    secs = time.perf_counter() - t0
    print("train " + json.dumps({
        "run": "launch.train", "argv": argv[3:-2], **{k: summary[k] for k in (
            "arch", "n_params", "tree_params", "param_dtype", "remat",
            "layers", "d_model",
            "vocab", "batch", "seq", "peak_bytes", "leaves", "leaves_moved",
            "random_leaves", "random_leaves_moved")},
        "loss": [s["loss"] for s in steps],
        "grad_norm": [s["grad_norm"] for s in steps],
        "s_per_step": [s["s"] for s in steps],
        "s_per_step_after_first": float(np.mean([s["s"] for s in steps[1:]])),
        "loop_seconds": summary["seconds"], "seconds": secs, "card": card}),
        flush=True)
    return secs


def _arrays(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def train_crash_resume(card: str):
    """The launcher's crash and resume on the card, yi_34b smoke, in this
    process: exit 42 after step 6 with step 5 on disk, ``--resume`` from
    step 5, and the final arrays against the uninterrupted run: bitwise
    where the card is deterministic, else within the reference's own
    launcher test's tolerance (``rtol=1e-5, atol=1e-6``)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train as launch
    from repro_torch.train import latest_step

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        a, b = f"{d}/a", f"{d}/b"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch.main(TRAIN_SMOKE + ["--ckpt-dir", a])
            try:
                launch.main(TRAIN_SMOKE + ["--ckpt-dir", b,
                                           "--simulate-failure", "6"])
                code = 0
            except SystemExit as e:
                code = e.code
            at = latest_step(b)
            launch.main(TRAIN_SMOKE + ["--ckpt-dir", b, "--resume"])
        log = out.getvalue()
        if code != 42 or at != 5 or "resumed from step 5" not in log:
            raise AssertionError(f"train crash/resume: exit {code}, latest "
                                 f"step {at}\n{log[-3000:]}")
        x = _arrays(f"{a}/step_00000010/arrays.npz")
        y = _arrays(f"{b}/step_00000010/arrays.npz")
    if sorted(x) != sorted(y):
        raise AssertionError("train crash/resume: the checkpoints' keys "
                             "differ")
    same = sum(x[k].tobytes() == y[k].tobytes() for k in x)
    err = max(float(np.max(np.abs(x[k].astype(np.float64)
                                  - y[k].astype(np.float64)))) for k in x)
    for k in x:
        if not np.allclose(y[k], x[k], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"train crash/resume: {k} differs by "
                                 f"{np.abs(y[k] - x[k]).max()}")
    print("train " + json.dumps({
        "run": "crash and resume", "argv": TRAIN_SMOKE, "exit": code,
        "resumed_from": at, "arrays": len(x), "bitwise": same,
        "max_abs_err": err, "seconds": time.perf_counter() - t0,
        "card": card}), flush=True)


def _nudged_tree(cfg, seed: int):
    """The port's init from a seed on the CPU, every constant leaf moved by
    seeded noise (numpy, float32)."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import init_params

    g = np.random.default_rng(700 + seed)

    def nudge(tree):
        if isinstance(tree, dict):
            return {k: nudge(v) for k, v in tree.items()}
        if tree.size and np.all(tree == tree.flat[0]):
            return (tree + g.normal(0, 0.2, tree.shape)).astype(np.float32)
        return tree

    return nudge(params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")))


def _train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    from repro_torch.data.lm import LMDataConfig, SyntheticLMData

    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["img"] = (cfg.n_img_tokens, cfg.d_model)
    return SyntheticLMData(LMDataConfig(vocab=cfg.vocab, batch=batch,
                                        seq_len=seq, seed=seed)
                           ).batch_for_step(0, extras)


def _leaf_err(got, want) -> float:
    """The largest difference of two trees' leaves, each over its own
    largest element of ``want``."""
    from repro_torch.train.optimizer import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        worst = max(worst, float((a - b).abs().max()
                                 / b.abs().max().clamp(min=1e-30)))
    return worst


def train_card_vs_cpu(dev, card: str):
    """One ``make_train_step`` per family at smoke width in f32 (``highest``
    matmul precision), on the card and on the CPU from the same weights:
    the gradients within ``TRAIN_GRAD_TOL`` of each leaf's largest element,
    the step's loss and grad norm within ``TRAIN_CURVE_RTOL``.  The MoE's
    backward scatters with atomics on the card (``index_put_`` with
    ``accumulate``): its sums may differ from run to run there."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import OptConfig, grads_and_loss, make_train_step

    torch.set_float32_matmul_precision("highest")
    cpu = torch.device("cpu")
    rows = []
    t0 = time.perf_counter()
    for i, arch in enumerate(TRAIN_FAMILIES):
        cfg = get_smoke_config(arch)
        tree = _nudged_tree(cfg, i)
        batch = _train_batch(cfg, 2, 16, i)
        res = {}
        for where in (cpu, dev):
            p = params_from_numpy(tree, cfg, device=where)
            b = {k: torch.tensor(v, device=where) for k, v in batch.items()}
            loss, grads = grads_and_loss(p, cfg, b)
            _, _, m = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=5))(
                p, _init_opt(p), b)
            res[where.type] = (loss, grads, m)
        tol = TRAIN_GRAD_TOL.get(arch, TRAIN_GRAD_TOL["default"])
        gerr = _leaf_err(res["cuda"][1], res["cpu"][1])
        cur = {k: abs(float(res["cuda"][2][k]) / float(res["cpu"][2][k]) - 1)
               for k in ("loss", "grad_norm")}
        if gerr > tol or max(cur.values()) > TRAIN_CURVE_RTOL:
            raise AssertionError(f"train {arch}: the card's gradients differ "
                                 f"from the CPU's by {gerr} of a leaf (bound "
                                 f"{tol}), loss and grad norm by {cur}")
        rows.append({"arch": arch, "family": cfg.family, "grad_err": gerr,
                     "grad_tol": tol, "loss_rel_err": cur["loss"],
                     "grad_norm_rel_err": cur["grad_norm"],
                     "loss": float(res["cuda"][2]["loss"])})
    print("train " + json.dumps({
        "run": "card against cpu, smoke configs, f32, one step",
        "configs": rows, "curve_rtol": TRAIN_CURVE_RTOL,
        "seconds": time.perf_counter() - t0, "card": card}), flush=True)


def _init_opt(params):
    from repro_torch.train import init_opt

    return init_opt(params)


def _train_crosspod(dev, mesh) -> dict:
    """``TRAIN_XPOD_STEPS`` int8 cross-pod steps of yi_34b smoke (f32) on
    ``mesh``, from seeded weights and a seeded batch of 8 rows: each step's
    loss and grad norm, the final params and the error feedback (a rank's
    own; on a logical mesh each pod's)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.train import (OptConfig, init_error_feedback,
                                   make_train_step_crosspod)

    cfg = get_smoke_config("yi_34b")
    params = params_from_numpy(_nudged_tree(cfg, 0), cfg, device=dev)
    batch = {k: torch.tensor(v, device=dev)
             for k, v in _train_batch(cfg, 8, 16, 0).items()}
    logical = not hasattr(mesh, "get_group")
    err = ([init_error_feedback(params) for _ in range(2)] if logical
           else init_error_feedback(params))
    opt = _init_opt(params)
    step = make_train_step_crosspod(cfg, OptConfig(lr=1e-3, warmup_steps=5),
                                    mesh, compress=True)
    out = {}
    for i in range(TRAIN_XPOD_STEPS):
        params, opt, err, m = step(params, opt, err, batch)
        out[f"loss{i}"] = np.float32(m["loss"].cpu())
        out[f"gnorm{i}"] = np.float32(m["grad_norm"].cpu())
    trees = {"params": params}
    for pod, e in enumerate(err if logical else [err]):
        trees[f"err{pod}"] = e
    for name, tree in trees.items():
        out.update({f"{name}{k}": v for k, v in
                    _lm_flat(params_to_numpy(tree)).items()})
    return out


def rank_train(ref_dir: str) -> int:
    """One of 2 gloo ranks sharing the card, started by ``python -m
    torch.distributed.run`` (:func:`train_ranks`): the int8 cross-pod step,
    its records into ``ref_dir``, then ``launch.train --data 2`` in the same
    process group (its metrics into ``ref_dir``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_from_env, make_local_mesh

    dev, backend = init_from_env("cuda")
    torch.set_float32_matmul_precision("highest")
    out = _train_crosspod(dev, make_local_mesh(pod=2))
    rank = dist.get_rank()
    np.savez(Path(ref_dir) / f"train_rank{rank}.npz", backend=backend, **out)
    launch.main(TRAIN_DP + ["--data", "2", "--metrics",
                            f"{ref_dir}/dp.jsonl"])
    dist.destroy_process_group()
    return 0


def train_ranks(dev, card: str):
    """Ranks sharing the card, 2 gloo processes of ``python -m
    torch.distributed.run`` (:func:`rank_train`): the int8 cross-pod step
    against the same step on a logical (2, 1, 1) mesh in this process, and
    ``launch.train --data 2`` in their process group against the one-rank
    run on the whole batch, each within the CPU tests' tolerances
    (loss and grad norm ``TRAIN_CURVE_RTOL``; the error feedback within one
    quantization scale an element, pod 0's scale from its first gradient;
    the CPU tests find the logical pods bitwise the ranks')."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import grads_and_loss

    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2",
                str(ROOT / "chip_smoke.py"), "--rank-train", "--ref-dir", d]
        procs = [subprocess.Popen(
            argv, env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
        # meanwhile, the one-process results
        logical = _train_crosspod(dev, make_local_mesh(pod=2))
        cfg = get_smoke_config("yi_34b")
        p = params_from_numpy(_nudged_tree(cfg, 0), cfg, device=dev)
        b = {k: torch.tensor(v[:4], device=dev)
             for k, v in _train_batch(cfg, 8, 16, 0).items()}
        scales = {f"err0{k}": float((np.abs(g).max() + 1e-12) / 127.0)
                  for k, g in _lm_flat(params_to_numpy(
                      grads_and_loss(p, cfg, b)[1])).items()}
        launch.main(TRAIN_DP + ["--metrics", f"{d}/one.jsonl"])
        _join(procs, "train ranks")
        ranks = [_arrays(f"{d}/train_rank{r}.npz") for r in range(2)]
        dp, _ = _train_metrics(Path(d) / "dp.jsonl")
        one, _ = _train_metrics(Path(d) / "one.jsonl")
    worst, bitwise = 0.0, True
    for r, got in enumerate(ranks):
        for i in range(TRAIN_XPOD_STEPS):
            for key in (f"loss{i}", f"gnorm{i}"):
                rel = abs(float(got[key]) / float(logical[key]) - 1)
                worst = max(worst, rel)
                if rel > TRAIN_CURVE_RTOL:
                    raise AssertionError(f"train cross-pod rank {r}: {key} "
                                         f"{got[key]} against {logical[key]}")
        for k in (k for k in got if k.startswith("err0/")):
            want = logical[k.replace("err0", f"err{r}", 1)]
            d_max = float(np.abs(got[k] - want).max())
            if r == 0 and d_max > scales[k] * (1 + 1e-5):
                raise AssertionError(f"train cross-pod rank {r}: {k} off by "
                                     f"{d_max}, scale {scales[k]}")
            bitwise &= got[k].tobytes() == want.tobytes()
        bitwise &= all(got[k].tobytes() == logical[k].tobytes()
                       for k in got if k.startswith("params"))
    dp_err = 0.0
    if [x["step"] for x in dp] != [x["step"] for x in one]:
        raise AssertionError("train --data 2: steps differ")
    for a, b in zip(dp, one):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] / b[key] - 1)
            dp_err = max(dp_err, rel)
            if rel > TRAIN_CURVE_RTOL:
                raise AssertionError(f"train --data 2: step {a['step']} "
                                     f"{key} {a[key]} against {b[key]}")
    print("train " + json.dumps({
        "run": "ranks sharing the card",
        "crosspod": {"ranks": 2, "backend": str(ranks[0]["backend"]),
                     "steps": TRAIN_XPOD_STEPS, "compress": True,
                     "max_rel_err": worst,
                     "bitwise_the_logical_pods": bool(bitwise)},
        "data_parallel": {"argv": TRAIN_DP + ["--data", "2"],
                          "launcher": "torch.distributed.run "
                          "--nproc-per-node 2 chip_smoke.py --rank-train",
                          "steps": len(dp),
                          "max_rel_err": dp_err,
                          "loss": [x["loss"] for x in dp]},
        "curve_rtol": TRAIN_CURVE_RTOL,
        "seconds": time.perf_counter() - t0, "card": card}), flush=True)


def train_phase(dev, card: str):
    """The LM harness's training side on the card (no kernel: plain
    PyTorch): :func:`train_full_width`, :func:`train_crash_resume`,
    :func:`train_card_vs_cpu`, :func:`train_ranks`; a ``train`` line each."""
    train_full_width(card)
    train_crash_resume(card)
    train_card_vs_cpu(dev, card)
    train_ranks(dev, card)


MESH_TRAIN = ["--arch", "yi_34b", "--layers", "2", "--steps", "4",
              "--batch", "8", "--seq", "128", "--log-every", "100"]
MESH_SERVE = ["lm", "--arch", "qwen3_moe_235b_a22b", "--layers", "4",
              "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
              "--tokens", str(LM_TOKENS)]
# the check in float32, cut to 2 layers (24.8 GB of weights on one rank)
MESH_SERVE_F32 = [*MESH_SERVE[:4], "2", *MESH_SERVE[5:], "--dtype",
                  "float32"]
# a top-two margin above it decides the greedy token on both float32 runs
# (the laid run's logits differ by its sums' order, about 1e-5 on the CPU)
MESH_F32_TOL = 1e-3
# the CPU tests' bf16 logit tolerance (atol): in bf16 the tokens are
# counted against it, not checked (a near-tie of the router's top-k, taken
# from activations rounded in another order, sends a token to another
# expert)
MESH_BF16_TOL = 6.25e-2
MESH_DRYRUN = ["--arch", "yi_34b", "--shape", "train_4k"]


def _gloo_cuda_probe(dev) -> dict:
    """Which collectives gloo carries on CUDA tensors, on this process
    group: each called on a small tensor of the card and its result held
    against the sum or the concatenation it must give."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(world * 4, dtype=torch.float32, device=dev) + rank
    every = [torch.arange(world * 4, dtype=torch.float32, device=dev) + r
             for r in range(world)]
    total = sum(every)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, total

    def all_gather():
        y = torch.empty(world * x.numel(), device=dev)
        dist.all_gather_into_tensor(y, x)
        return y, torch.cat(every)

    def reduce_scatter():
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return y, total[rank * 4:(rank + 1) * 4]

    def all_to_all():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y, torch.cat([e[rank * 4:(rank + 1) * 4] for e in every])

    def all_reduce_bf16():
        y = x.to(torch.bfloat16)
        dist.all_reduce(y)
        return y, total.to(torch.bfloat16)

    out = {}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter),
                     ("all_to_all", all_to_all),
                     ("all_reduce_bf16", all_reduce_bf16)):
        try:
            got, want = fn()
            out[name] = ("ok" if torch.equal(got.cpu(), want.cpu())
                         else "wrong values")
        except Exception as e:  # the backend's refusal is the finding
            out[name] = f"refused: {type(e).__name__}: {str(e)[:200]}"
    return out


def rank_mesh(ref_dir: str) -> int:
    """One of 2 gloo ranks sharing the card (:func:`mesh_phase`), started
    up beside the last one-rank run and waiting for its end: the
    collectives probe, then (a) ``launch.train --model 2`` in float32, (b)
    in bf16, (c) ``serve lm --model 2``, each in this process group, their
    records into ``ref_dir``."""
    import faulthandler

    faulthandler.enable()  # a fault in a rank prints its Python stack
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_from_env

    dev, backend = init_from_env("cuda")
    torch.set_float32_matmul_precision("highest")
    _wait_for(Path(ref_dir) / "mesh.go")
    probe = _gloo_cuda_probe(dev)
    if dist.get_rank() == 0:
        (Path(ref_dir) / "gloo.json").write_text(json.dumps(
            {"backend": backend, "collectives": probe}))
    t0 = time.perf_counter()
    launch.main(MESH_TRAIN + ["--dtype", "float32", "--model", "2",
                              "--metrics", f"{ref_dir}/tp32.jsonl"])
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    launch.main(MESH_TRAIN + ["--model", "2", "--metrics",
                              f"{ref_dir}/tp16.jsonl"])
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    serve.main(MESH_SERVE_F32 + ["--model", "2", "--tokens-out",
                                 f"{ref_dir}/serve32_tp.npz"])
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    serve.main(MESH_SERVE + ["--model", "2", "--tokens-out",
                             f"{ref_dir}/serve_tp.npz"])
    t4 = time.perf_counter()
    if dist.get_rank() == 0:
        (Path(ref_dir) / "rank_seconds.json").write_text(json.dumps(
            {"train_f32": t1 - t0, "train_bf16": t2 - t1,
             "serve_f32": t3 - t2, "serve": t4 - t3}))
    dist.destroy_process_group()
    return 0


def _greedy_agreement(got, want, margins, tol: float,
                      strict: bool = True) -> dict:
    """Row by row, the laid run's tokens against one rank's: a step whose
    one-rank top-two margin exceeds ``tol`` must agree (``strict``; else it
    is counted as ``differ``), and a step that differs ends the row's
    comparison (the inputs part from there)."""
    checked = close = differ = after = 0
    for r in range(want.shape[0]):
        for t in range(want.shape[1]):
            same = got[r, t] == want[r, t]
            if margins[r, t] > tol:
                if not same and strict:
                    raise AssertionError(
                        f"mesh serve: row {r} step {t}: token {got[r, t]} "
                        f"against {want[r, t]} at a margin of "
                        f"{margins[r, t]}")
                checked += 1
                differ += not same
            else:
                close += 1
            if not same:
                after += want.shape[1] - t - 1
                break
    return {"checked": checked, "differ": differ, "within_tol": close,
            "not_compared": after}


def mesh_phase(dev, card: str):
    """The LM harness laid over a ``(data, model)`` mesh (no kernel; see
    the module docstring, item 19): (a) to (d) (:func:`_mesh_runs`), with
    (e)'s ranks starting up beside (a) to (c)'s, then (e)
    (:func:`mesh_xpod`).  A ``mesh`` line each."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        procs = {}
        try:
            _mesh_runs(dev, card, lambda: procs.update(_xpod_launch(d)))
            mesh_xpod(card, d, procs)
        finally:
            _stop(procs.values())


def _stop(procs):
    """End the processes still running (after a failure: the rest have
    been joined), each launcher given the time to end its ranks."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()


def _wait_for(path: Path):
    """Wait for ``path`` to exist: a rank started up ahead of its turn."""
    deadline = time.monotonic() + RANK_RUN_TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise AssertionError(f"no {path.name} within "
                                 f"{RANK_RUN_TIMEOUT_S} s")
        time.sleep(0.05)


def _mesh_runs(dev, card: str, before_ranks):
    """(a) to (d): the one-rank runs first, each in a process of its own
    that frees the card, then one ``torch.distributed.run`` of 2 gloo
    ranks (:func:`rank_mesh`, started up beside the last one-rank run;
    ``before_ranks()`` is called just before it starts), the dry run on
    the host beside them.  A ``mesh`` line each."""
    import tempfile

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        dry = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *MESH_DRYRUN,
             "--out", f"{d}/dry.jsonl"],
            env=dict(env, CUDA_VISIBLE_DEVICES=""), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # the two float32 runs side by side (37.9 and 28.1 GB at their
        # peaks), then the bf16 one
        one = [[[sys.executable, "-m", "repro_torch.launch.train",
                 *MESH_TRAIN, "--dtype", "float32", "--metrics",
                 f"{d}/one32.jsonl"],
                [sys.executable, "-m", "repro_torch.launch.serve",
                 *MESH_SERVE_F32, "--tokens-out", f"{d}/serve32_one.npz"]],
               [[sys.executable, "-m", "repro_torch.launch.serve",
                 *MESH_SERVE, "--tokens-out", f"{d}/serve_one.npz"]]]
        ranks = []
        try:
            for g, group in enumerate(one):
                if g == len(one) - 1:
                    # the ranks start up beside the last one-rank run and
                    # wait for its end
                    before_ranks()
                    ranks.append(subprocess.Popen(
                        [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", "2",
                         str(ROOT / "chip_smoke.py"), "--rank-mesh",
                         "--ref-dir", d],
                        env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
                _join([subprocess.Popen(argv, env=env, cwd=ROOT,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                       for argv in group], "mesh one rank")
            t_one = time.perf_counter() - t0
            (Path(d) / "mesh.go").write_text("")
            _join(ranks, "mesh ranks")
        finally:
            _stop(ranks)
        t_ranks = time.perf_counter() - t0 - t_one
        dry_log = _join([dry], "mesh dry run")[0]
        gloo = json.loads((Path(d) / "gloo.json").read_text())
        rank_s = json.loads((Path(d) / "rank_seconds.json").read_text())
        tp32, s32 = _train_metrics(Path(d) / "tp32.jsonl")
        one32, o32 = _train_metrics(Path(d) / "one32.jsonl")
        tp16, s16 = _train_metrics(Path(d) / "tp16.jsonl")
        sv_tp = dict(np.load(f"{d}/serve_tp.npz"))
        sv_one = dict(np.load(f"{d}/serve_one.npz"))
        sv32_tp = dict(np.load(f"{d}/serve32_tp.npz"))
        sv32_one = dict(np.load(f"{d}/serve32_one.npz"))
        dry = json.loads((Path(d) / "dry.jsonl").read_text().splitlines()[0])
    print("mesh " + json.dumps({"run": "gloo on CUDA tensors", **gloo,
                                "card": card}), flush=True)
    # (a) tensor parallelism against one rank, float32
    if [x["step"] for x in tp32] != [x["step"] for x in one32]:
        raise AssertionError("mesh train: steps differ")
    worst = 0.0
    for a, b in zip(tp32, one32):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] / b[key] - 1)
            worst = max(worst, rel)
            if not rel <= TRAIN_CURVE_RTOL:
                raise AssertionError(f"mesh train --model 2: step "
                                     f"{a['step']} {key} {a[key]} against "
                                     f"{b[key]}")
    if not 0 < s32["model_leaves_split"] == s32["model_leaves"]:
        raise AssertionError(f"mesh train: {s32['model_leaves_split']} of "
                             f"{s32['model_leaves']} leaves laid on model "
                             "split in half")
    if s32["random_leaves_moved"] != s32["random_leaves"]:
        raise AssertionError("mesh train: a leaf did not move")
    keys = ("arch", "layers", "d_model", "vocab", "compute_dtype", "batch",
            "seq", "tree_params", "peak_bytes_ranks", "local_bytes",
            "model_leaves", "model_leaves_split")
    print("mesh " + json.dumps({
        "run": "(a) launch.train --model 2, float32, against one rank",
        "argv": MESH_TRAIN + ["--dtype", "float32", "--model", "2"],
        **{k: s32[k] for k in keys},
        "one_rank_peak_bytes": o32["peak_bytes"],
        "one_rank_local_bytes": o32["local_bytes"],
        "loss": [x["loss"] for x in tp32],
        "grad_norm": [x["grad_norm"] for x in tp32],
        "max_rel_err": worst, "curve_rtol": TRAIN_CURVE_RTOL,
        "s_per_step": [x["s"] for x in tp32],
        "one_rank_s_per_step": [x["s"] for x in one32],
        "seconds": rank_s["train_f32"], "card": card}), flush=True)
    # (b) the same in bf16, for its seconds a step
    for x in tp16:
        if not (np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])):
            raise AssertionError(f"mesh train bf16: step {x['step']}")
    print("mesh " + json.dumps({
        "run": "(b) launch.train --model 2, bf16",
        "argv": MESH_TRAIN + ["--model", "2"],
        **{k: s16[k] for k in keys},
        "loss": [x["loss"] for x in tp16],
        "s_per_step": [x["s"] for x in tp16],
        "s_per_step_after_first": float(np.mean([x["s"] for x in tp16[1:]])),
        "seconds": rank_s["train_bf16"], "card": card}), flush=True)
    # (c) serving laid on model against one rank: checked in float32,
    # timed (and counted) in bf16
    agree32 = _greedy_agreement(sv32_tp["tokens"], sv32_one["tokens"],
                                sv32_one["margins"], MESH_F32_TOL)
    if not agree32["checked"]:
        raise AssertionError("mesh serve float32: no token decided")
    print("mesh " + json.dumps({
        "run": "(c) serve lm --model 2, float32, against one rank",
        "argv": MESH_SERVE_F32 + ["--model", "2"], **agree32,
        "f32_tol": MESH_F32_TOL,
        "max_margin_diff": float(np.abs(
            sv32_tp["margins"] - sv32_one["margins"]).max()),
        **{k: float(sv32_tp[k]) for k in ("ms_per_token", "tok_per_s")},
        "peak_bytes_ranks": sv32_tp["peak_bytes"].tolist(),
        "one_rank_peak_bytes": sv32_one["peak_bytes"].tolist(),
        "seconds": rank_s["serve_f32"], "card": card}), flush=True)
    agree = _greedy_agreement(sv_tp["tokens"], sv_one["tokens"],
                              sv_one["margins"], MESH_BF16_TOL,
                              strict=False)
    print("mesh " + json.dumps({
        "run": "(c) serve lm --model 2, bf16, against one rank",
        "argv": MESH_SERVE + ["--model", "2"], **agree,
        "bf16_tol": MESH_BF16_TOL,
        **{k: float(sv_tp[k]) for k in ("prefill_s", "ms_per_token",
                                        "tok_per_s")},
        "peak_bytes_ranks": sv_tp["peak_bytes"].tolist(),
        "one_rank": {k: float(sv_one[k]) for k in (
            "prefill_s", "ms_per_token", "tok_per_s")},
        "one_rank_peak_bytes": sv_one["peak_bytes"].tolist(),
        "seconds": rank_s["serve"], "card": card}), flush=True)
    # (d) the dry run of one full-width cell on the host
    if dry.get("status") != "ok":
        raise AssertionError(f"mesh dry run: {dry}\n{dry_log[-3000:]}")
    print("mesh " + json.dumps({
        "run": "(d) launch.dryrun " + " ".join(MESH_DRYRUN),
        **{k: dry[k] for k in ("mesh", "trace_s", "memory", "collectives")},
        "flops": dry["cost"]["flops"], "roofline": dry["roofline"],
        "one_rank_runs_s": t_one, "ranks_s": t_ranks,
        "seconds": time.perf_counter() - t0, "card": card}), flush=True)


# (e) the int8 cross-pod step laid on model: h2o_danube_3_4b at its
# published widths, cut to 2 of 24 layers, float32, batch 8 x 128
XPOD_ARCH, XPOD_LAYERS, XPOD_BATCH, XPOD_SEQ = "h2o_danube_3_4b", 2, 8, 128
XPOD_STEPS = 3
XPOD_RTOL = 2e-5


def _xpod_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(XPOD_ARCH), n_layers=XPOD_LAYERS,
                               param_dtype="float32",
                               compute_dtype="float32")


def rank_xpod(ref_dir: str, model: int) -> int:
    """One rank of :func:`mesh_xpod`'s ``(2, 1, model)`` mesh, gloo ranks
    sharing the card under ``torch.distributed.run``: ``XPOD_STEPS`` int8
    cross-pod steps from seeded weights (laid on the pod's mesh with
    ``model`` 2) on a seeded batch.  Rank 0 records each step's loss, grad
    norm and seconds; every rank its peak, local bytes, the int8 bytes it
    gathers a step, and (``model`` 2) the leaves laid on ``model`` and
    split.  After step 1, ``model`` 2's pod-0 ranks save their shards of
    the error feedback; ``model`` 1's rank 0 holds its own against them on
    the card, each element within one of pod 0's scales (from its first
    gradient)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.dist import local_bytes
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import (init_from_env, make_local_mesh,
                                         pod_mesh)
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, grads_and_loss,
                                   init_error_feedback,
                                   make_train_step_crosspod)
    from repro_torch.train.optimizer import tree_leaves

    marks = {"start": time.time()}
    dev, _ = init_from_env("cuda")
    torch.set_float32_matmul_precision("highest")
    rank, ref = dist.get_rank(), Path(ref_dir)
    marks["group"] = time.time()
    # started up beside earlier work; (2, 1, 2) runs at the go, (2, 1, 1)
    # after it
    _wait_for(ref / ("xpod.go" if model > 1 else "xpod2.done"))
    marks["go"] = time.time()
    cfg = _xpod_config()
    mesh = make_local_mesh(data=1, model=model, pod=2,
                           device_type=dev.type)
    sub = pod_mesh(mesh) if model > 1 else None
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, mesh=sub)
    batch = {k: torch.tensor(v, device=dev) for k, v in _train_batch(
        cfg, XPOD_BATCH, XPOD_SEQ, 0).items()}
    scales = None
    if model == 1 and rank == 0:  # pod 0's first gradient's scales
        g0 = grads_and_loss(params, cfg, {k: v[: XPOD_BATCH // 2]
                                          for k, v in batch.items()})[1]
        scales = [(torch.max(torch.abs(g.float())) + 1e-12) / 127
                  for g in tree_leaves(g0)]
        del g0
    opt = _init_opt(params)
    err = init_error_feedback(params)
    before = launch._checksums(params)
    marks["init"] = time.time()
    step = make_train_step_crosspod(cfg, OptConfig(lr=1e-3, warmup_steps=5),
                                    mesh, compress=True)
    rows = []
    for i in range(XPOD_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, batch)
        torch.cuda.synchronize(dev)
        rows.append({"loss": float(m["loss"]), "grad_norm":
                     float(m["grad_norm"]), "s": time.perf_counter() - t0})
        if i == 0:
            marks["step1"] = time.time()
            _xpod_err(err, ref, rank, model, scales)
            marks["err"] = time.time()
    marks["steps"] = time.time()
    moved = launch._moved(before, launch._checksums(params), True)
    leaves = tree_leaves(params)
    local = sum(launch._local(p).numel() for p in leaves)
    record = {"rank": rank, "peak_bytes": torch.cuda.max_memory_allocated(
                  dev),
              "local_bytes": local_bytes({"params": params, "opt": opt,
                                          "err": err}),
              "local_params": local,
              # each leaf's int8 shard and f32 scale from both pods
              "gathered_bytes_per_step": 2 * (local + 4 * len(leaves)),
              "leaves": len(leaves), "leaves_moved": sum(moved),
              "params": sum(p.numel() for p in leaves)}
    if sub is not None:
        record["model_leaves"], record["model_leaves_split"] = (
            launch._model_split(params, sub))
    if rank == 0:
        record["steps"] = rows
    marks["end"] = time.time()
    record["marks"] = marks
    (ref / f"xpod{model}_r{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()
    return 0


def _xpod_err(err, ref: Path, rank: int, model: int, scales):
    """After step 1: ``model`` 2's pod-0 ranks save their shards of the
    error feedback (and the dimension each is split on); ``model`` 1's rank
    0 holds its whole leaves against them leaf by leaf on the card."""
    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(err)
    if model > 1:
        if rank < model:  # pod 0: ranks (0, 0, m)
            i = leaves[0].device_mesh.mesh_dim_names.index("model")
            torch.save([(e.to_local().cpu(), e.placements[i].dim
                         if e.placements[i].is_shard() else None)
                         for e in leaves], ref / f"xpod_err_r{rank}.pt")
        return
    if rank != 0:
        return
    shards = [torch.load(ref / f"xpod_err_r{m}.pt") for m in range(2)]
    worst, flips = 0.0, 0
    for i, (e, scale) in enumerate(zip(leaves, scales)):
        parts, dim = [s[i][0] for s in shards], shards[0][i][1]
        laid_e = (parts[0] if dim is None else torch.cat(parts, dim)).to(
            e.device)
        d = torch.abs(laid_e - e)
        worst = max(worst, float(torch.max(d / scale)))
        flips += int(torch.sum(d > scale / 2))
    (ref / "xpod_err.json").write_text(json.dumps(
        {"max_err_over_scale": worst, "flips": flips,
         "elements": sum(e.numel() for e in leaves)}))


def _xpod_launch(d: str) -> dict:
    """:func:`mesh_xpod`'s two ``torch.distributed.run`` launches, started
    together ahead of it: their ranks start up and wait for its go."""
    return {model: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), str(ROOT / "chip_smoke.py"),
         "--rank-xpod", str(model), "--ref-dir", d],
        env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for model, world in ((2, 4), (1, 2))}


def mesh_xpod(card: str, d: str, procs: dict):
    """(e) The int8 cross-pod step laid on ``model``
    (``make_train_step_crosspod`` on a ``(2, 1, 2)`` rank mesh, 4 gloo
    ranks sharing the card, each pod's state laid on its ``(1, 2)`` mesh)
    at full width, then the same steps on ``(2, 1, 1)`` (2 ranks, the
    whole model a pod), the launches of :func:`_xpod_launch` in ``d``, one
    after the other: loss and grad norm per step within ``XPOD_RTOL``, the
    error feedback after step 1 within one of pod 0's scales an element,
    every leaf moved, each rank's leaves laid on ``model`` at half their
    elements.  A ``mesh`` line."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (Path(d) / "xpod.go").write_text("")
    _join([procs[2]], "mesh xpod (2, 1, 2)")
    (Path(d) / "xpod2.done").write_text("")
    _join([procs[1]], "mesh xpod (2, 1, 1)")
    runs = {model: [json.loads((Path(d) / f"xpod{model}_r{r}.json")
                               .read_text()) for r in range(world)]
            for model, world in ((2, 4), (1, 2))}
    errs = json.loads((Path(d) / "xpod_err.json").read_text())
    # rank 0's seconds from its go to each mark (its start-up before it)
    timeline = {model: {k: v - runs[model][0]["marks"]["go"]
                        for k, v in runs[model][0]["marks"].items()}
                for model in runs}
    laid, whole = runs[2], runs[1]
    worst = 0.0
    for a, b in zip(laid[0]["steps"], whole[0]["steps"]):
        for key in ("loss", "grad_norm"):
            if not (np.isfinite(a[key]) and np.isfinite(b[key])):
                raise AssertionError(f"mesh xpod: {key} {a[key]}, {b[key]}")
            rel = abs(a[key] / b[key] - 1)
            worst = max(worst, rel)
            if not rel <= XPOD_RTOL:
                raise AssertionError(f"mesh xpod: {key} {a[key]} on (2, 1, "
                                     f"2) against {b[key]} on (2, 1, 1)")
    if not errs["max_err_over_scale"] <= 1 + 1e-5:
        raise AssertionError(f"mesh xpod: error feedback off by "
                             f"{errs['max_err_over_scale']} scales")
    for r in laid + whole:
        if r["leaves_moved"] != r["leaves"]:
            raise AssertionError(f"mesh xpod: rank {r['rank']} moved "
                                 f"{r['leaves_moved']} of {r['leaves']}")
    for r in laid:
        if not 0 < r["model_leaves_split"] == r["model_leaves"]:
            raise AssertionError(f"mesh xpod: rank {r['rank']}: "
                                 f"{r['model_leaves_split']} of "
                                 f"{r['model_leaves']} model leaves halved")
    print("mesh " + json.dumps({
        "run": "(e) make_train_step_crosspod int8 on (2, 1, 2), 4 gloo "
               "ranks, against (2, 1, 1), 2 ranks",
        "arch": XPOD_ARCH, "layers": XPOD_LAYERS, "dtype": "float32",
        "batch": XPOD_BATCH, "seq": XPOD_SEQ, "params": laid[0]["params"],
        "loss": [x["loss"] for x in laid[0]["steps"]],
        "grad_norm": [x["grad_norm"] for x in laid[0]["steps"]],
        "max_rel_err": worst, "rtol": XPOD_RTOL, **errs,
        "model_leaves": laid[0]["model_leaves"],
        "s_per_step": [x["s"] for x in laid[0]["steps"]],
        "whole_s_per_step": [x["s"] for x in whole[0]["steps"]],
        "local_params_ranks": [r["local_params"] for r in laid],
        "whole_local_params_ranks": [r["local_params"] for r in whole],
        "peak_bytes_ranks": [r["peak_bytes"] for r in laid],
        "whole_peak_bytes_ranks": [r["peak_bytes"] for r in whole],
        "gathered_int8_bytes_per_step_ranks": [
            r["gathered_bytes_per_step"] for r in laid],
        "whole_gathered_int8_bytes_per_step_ranks": [
            r["gathered_bytes_per_step"] for r in whole],
        "timeline": timeline[2], "whole_timeline": timeline[1],
        "seconds": time.perf_counter() - t0, "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-objects", type=int, default=1_000_000)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and spill report")
    ap.add_argument("--short-api", action="store_true",
                    help="run the kernel API path at 62,500 rows instead "
                         "of 1,000,000 (a first check)")
    # one rank of the distributed phase (spawned by it, never by hand)
    ap.add_argument("--rank-path", choices=sorted(OBJECT_PATHS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-server", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-train", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-mesh", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-xpod", type=int, choices=(1, 2),
                    help=argparse.SUPPRESS)
    ap.add_argument("--only-mesh", action="store_true",
                    help="run only the mesh phase (no kernel is built or "
                         "checked; no kernels line)")
    ap.add_argument("--ref-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.rank_path:
        return rank_path(args.rank_path, args.n_objects, args.ref_dir)
    if args.rank_server:
        return rank_server(args.n_objects, args.ref_dir)
    if args.rank_train:
        return rank_train(args.ref_dir)
    if args.rank_mesh:
        return rank_mesh(args.ref_dir)
    if args.rank_xpod:
        return rank_xpod(args.ref_dir, args.rank_xpod)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if args.only_mesh:
        mesh_phase(dev, card)
        return 0
    t0 = time.perf_counter()
    built = {}

    def build_kernels():
        try:
            build.build_all(verbose=args.ptxas)
        except Exception as e:  # raised again below, in the main thread
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    # nvcc builds on the host while the LM harness, which reaches no
    # kernel, runs on the card
    builder = threading.Thread(target=build_kernels)
    builder.start()
    # seconds per phase, printed before the kernels' line: where the run's
    # time limit goes
    phases = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phases[name] = now - clock[0]
        clock[0] = now

    lm_phase(dev, card)
    lap("lm")
    train_phase(dev, card)
    lap("train")
    torch.cuda.empty_cache()
    builder.join()
    if "error" in built:
        raise built["error"]
    print(f"build: {len(build.SOURCES)} source(s) in {built['s']:.1f} s, "
          "beside the lm and train phases")
    phases["build"] = built["s"]
    lap("build_wait")
    check_fma(dev)
    b1 = {}
    for q in (8192, 123 * (512 if args.short_api else 8192)):
        for r in kernel_phase(dev, q=q):
            _add_shape(b1, r["name"], r)
    rec, rec_mixed = b1["fused_scan_merge"], b1["fused_scan_merge_mixed"]
    rec_multi, rec_lists = merge_kernel_phase(dev)
    wide = wide_kernel_phase(dev)
    nav = nav_phase(dev)
    lap("kernels")
    api = kernel_api_path(dev, full=not args.short_api)
    n = args.n_objects
    baseline_check(dev, n)
    lap("kernel_api")
    from repro_torch.kernels import nav_walk as nw

    nav_before = nw.nav_walk.launches
    total, _ = main_path(dev, n)
    lap("single")
    rec["launches"] = total["fused_scan_merge"]
    rec_mixed["launches"] = total["fused_scan_merge_mixed"]
    for r in nav:
        r["launches"] = nw.nav_walk.launches - nav_before
    kept = {"a": [], "b": []}
    counts_a, ticks_a = object_path(dev, n, "a", seed=0, keep=kept["a"])
    # the ranks of the distributed phase start up during path (b)
    started = start_distributed(n)
    try:
        counts_b, ticks_b = object_path(dev, n, "b", seed=0, keep=kept["b"])
        for label, counts, kernel in (("a", counts_a, "merge_topk_multi"),
                                      ("b", counts_b, "merge_topk_lists")):
            for name in ("fused_scan_merge", kernel):
                if counts[name] < 1:
                    raise AssertionError(f"path {label}: {name} never "
                                         "launched")
        rec_multi["launches"] = counts_a["merge_topk_multi"]
        rec_lists["launches"] = counts_b["merge_topk_lists"]
        lap("object_axis")
    except BaseException:
        _stop([p for ranks in started[1].values() for p in ranks])
        shutil.rmtree(started[0], ignore_errors=True)
        raise
    ranks = distributed(n, kept, {"a": ticks_a, "b": ticks_b}, card,
                        started)
    del kept
    for r, name in ((rec, "B1"), (rec_multi, "B2"), (rec_lists, "B3")):
        r["distributed_launches"] = ranks[name]
    driver_ranks(n, card)
    server_launches = server_ranks(min(n, RANK_SERVER_N), card)
    rec["distributed_launches"] += server_launches["B1"]
    rec_multi["distributed_launches"] += server_launches["B2"]
    lap("distributed")
    # the host-bound object-axis sessions run at 50,000 objects: each still
    # launches the wide template or takes the maintenance route it is for
    n_axis = min(n, 50_000)
    for name, count in wide_sessions(dev, min(n, 200_000), n_axis).items():
        wide[name]["launches"] = count
    lap("wide_sessions")
    incremental_object_path(dev, n_axis)
    lap("incremental_object_axis")
    rec["server_launches"] = server_path(dev, n)
    lap("server")
    entry_point(n)
    lap("entry_point")
    rec["evaluation_launches"], rec_multi["evaluation_launches"] = (
        evaluation(dev, n, min(n, 200_000), card))
    lap("evaluation")
    prop_launches, prop_shapes = properties(dev, n, min(n, 200_000),
                                            short=args.short_api)
    for r in (rec, rec_mixed, rec_multi, rec_lists):
        r["properties_launches"] = prop_launches[r["name"]]
    lap("properties")
    mesh_phase(dev, card)
    lap("mesh")
    narrow = ("topk_select", "bucket_kselect", "pairwise_dist")
    records = [rec, rec_mixed, rec_multi, rec_lists,
               *(api[name] for name in narrow), *wide.values(), *nav,
               *(r for name, r in api.items() if name not in narrow)]
    for r in records:
        if not r["launches"] or r["launches"] < 1:
            raise AssertionError(f"{r['name']}: no launch on its path")
        if r["name"] in prop_shapes:
            r["properties_shapes"] = prop_shapes[r["name"]]
        r["card"] = card
    phases["total"] = time.perf_counter() - t0
    print("phases " + json.dumps(phases))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
