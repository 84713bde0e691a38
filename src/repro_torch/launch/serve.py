"""The serving entry points of the port.

Counterpart of ``repro/launch/serve.py``, in two modes; both run on the
card unless given ``--device cpu``.

  knn — repeated k-NN query batches over moving objects, one batch per
        tick, served through a :class:`repro_torch.api.KnnSession`, or with
        ``--tenants N`` through one :class:`repro_torch.serve.KnnServer`
        shared by N tenants.
  lm  — batched LM token serving: prefill a batch of prompts, then decode
        tokens with the per-layer KV cache / recurrent state
        (``repro_torch.models``), on one device, or under
        ``torch.distributed.run`` laid over ``--data`` x ``--model`` ranks
        by the rule tables (weights by ``param_logical``, the decode
        state by ``launch.specs``: caches ``kv`` on ``model``,
        ``cache_batch`` on ``data``).  As the reference, the prefill does
        not seed the decode cache: decoding starts at ``pos = prompt_len``
        on an empty cache.

Under ``python -m torch.distributed.run --nproc-per-node N`` every process
joins the process group the launcher describes
(:func:`repro_torch.launch.mesh.init_from_env`: NCCL when every rank has a
card of its own, gloo on the CPU and when ranks share a card), and a mesh
plan lays one grid cell on each of the N ranks (its ``mesh_shape`` is left
None: the world size).
Every rank serves the same ticks (with ``--tenants``, every rank runs a
replica of the server fed the same calls); rank 0 prints the tick lines,
and every rank checks its own lists and that they equal every other
rank's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve knn --objects 50000 --ticks 10 --k 32
  PYTHONPATH=src python -m repro_torch.launch.serve knn --objects 1000000 --ticks 3 --tenants 4
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve knn --plan object_sharded [--tenants 4]
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch rwkv6_3b --smoke --tokens 16
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve lm --arch yi_34b --smoke --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..api import KnnSession, ServiceSpec
from ..configs import ARCH_IDS
from ..data.generators import make_workload
from ..models import (decode_step, encode_memory, forward, init_decode_state,
                      init_params, seed_decode_state)
from ..dist import current_rules, is_rank_mesh, lay, use_rules, whole
from ..runtime import resolve_device
from ..train.step import lay_batch
from .mesh import init_from_env, make_local_mesh
from .specs import lay_decode_state
from .train import config_of


def _check_lists(idx, dist_, n_objects: int, k: int, tick: int) -> str:
    """Raise unless every row is ``k`` ascending distances over object ids
    (``(inf, -1)`` padded); return a digest of the lists' bits."""
    if idx.shape[1] != k or dist_.shape != idx.shape:
        raise AssertionError(f"tick {tick}: lists of shape {idx.shape}")
    filled = idx >= 0
    if (idx >= n_objects).any() or not np.isfinite(dist_[filled]).all() or (
            np.diff(dist_, axis=1) < 0).any() or not np.isinf(
            dist_[~filled]).all():
        raise AssertionError(f"tick {tick}: malformed lists")
    return hashlib.sha256(idx.tobytes() + dist_.tobytes()).hexdigest()


def _same_on_every_rank(digests, tick: int):
    """Raise unless every rank gathered the same ``digests``."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digests)
    if any(d != digests for d in every):
        raise AssertionError(f"tick {tick}: the ranks' lists differ "
                             f"({every})")


def serve_knn(args, device=None) -> int:
    """One session over ``--ticks`` ticks; ``device`` (this rank's, under a
    process group) overrides ``--device``."""
    spec = ServiceSpec(k=args.k, th_quad=args.th_quad, l_max=args.l_max,
                       chunk=args.chunk, plan=args.plan,
                       partitioner=args.partitioner, collect=args.collect,
                       maintenance=args.maintenance)
    if args.tenants > 1:
        return serve_knn_tenants(args, spec, device)
    ranked = dist.is_initialized()
    session = KnnSession(spec, device=device or args.device)
    lead = not ranked or dist.get_rank() == 0
    w = make_workload(args.objects, args.distribution, seed=args.seed)
    tput = []

    def on_tick(res, tick_s):
        # tick_s spans staging + submit + result, without the kernel build
        qps = args.objects / max(tick_s, 1e-9)
        tput.append(qps)
        extra = f" compile={res.compile_s:.2f}s" if res.compile_s else ""
        if not lead:
            return
        print(
            f"[knn] tick {res.tick}: {tick_s * 1e3:.1f} ms, "
            f"{qps / 1e3:.1f}K queries/s, iters={res.iterations} "
            f"rebuilt={res.rebuilt} maint={res.maintenance}{extra}",
            flush=True,
        )

    # queries registered once; --churn 1.0 ingests a whole snapshot a tick,
    # a fraction feeds only the moved rows through update_objects (the
    # regime where --maintenance incremental splices)
    session.ingest_objects(w.positions())
    cur = np.asarray(w.positions(), np.float32).copy()
    churn_rng = np.random.default_rng(args.seed + 1)
    hq = session.register_queries(*w.query_batch(1.0))
    for t in range(args.ticks):
        t0 = time.time()
        if t > 0:
            w.advance()
            new = np.asarray(w.positions(), np.float32)
            if args.churn < 1.0:
                d = max(1, int(round(args.objects * args.churn)))
                ids = churn_rng.choice(args.objects, d,
                                       replace=False).astype(np.int32)
                cur[ids] = new[ids]
                session.update_objects(ids, cur[ids])
            else:
                cur = new.copy()
                session.ingest_objects(cur)
            session.update_queries(hq, w.query_batch(1.0)[0])
        res = session.submit().result()
        on_tick(res, time.time() - t0 - res.compile_s)
        if res.nn_idx is not None:
            digest = _check_lists(res.nn_idx, res.nn_dist, args.objects,
                                  args.k, res.tick)
            if ranked:
                _same_on_every_rank(digest, res.tick)
    if not lead:
        return 0
    if ranked:
        print(f"[knn] {dist.get_world_size()} ranks ended every tick with "
              "the same lists", flush=True)
    if len(tput) > 1:
        print(f"[knn] steady-state throughput: {np.median(tput[1:]):.0f} "
              "queries/s")
    return 0


def serve_knn_tenants(args, spec, device=None) -> int:
    """N tenants through one shared server.

    Queries split round-robin across tenants; each tick's whole-population
    delta is fed by the next tenant in turn, so every tenant drives the
    shared-world path.  Under a process group every rank runs a replica of
    the server on ``device`` (this rank's), fed the same calls: its host
    state (registry, cache, epoch) evolves alike on every rank, so every
    rank takes the same branches and joins the same collectives.  Rank 0
    prints; every rank checks each tenant's lists and that they equal
    every other rank's.
    """
    from ..serve import KnnServer

    ranked = dist.is_initialized()
    lead = not ranked or dist.get_rank() == 0
    server = KnnServer(spec, device=device or args.device)
    w = make_workload(args.objects, args.distribution, seed=args.seed)
    T = args.tenants
    server.ingest_objects(w.positions())
    qpos, qid = w.query_batch(1.0)
    tenants = [server.admit(f"tenant-{i}") for i in range(T)]
    groups = [t.register_queries(qpos[i::T], qid[i::T])
              for i, t in enumerate(tenants)]
    all_ids = np.arange(args.objects, dtype=np.int32)
    if lead:
        print(f"[knn] {server.describe()}")
    walls = []
    for t in range(args.ticks):
        t0 = time.time()
        if t > 0:
            w.advance()
            cur = np.asarray(w.positions(), np.float32)
            tenants[t % T].update_objects(all_ids, cur)
            newq = w.query_batch(1.0)[0]
            for i, tn in enumerate(tenants):
                tn.update_queries(groups[i], newq[i::T])
        st = server.submit()
        res = st.result()
        wall = time.time() - t0 - res.compile_s
        walls.append(wall)
        if lead:
            print(f"[knn] tick {res.tick}: {wall * 1e3:.1f} ms, "
                  f"rows={res.rows_total} computed={res.rows_computed} "
                  f"hit={res.hit_rate:.2f} epoch={res.epoch} "
                  f"rebuilt={res.rebuilt}", flush=True)
        if spec.collect == "none":
            continue
        digests = []
        for tn in tenants:
            ii, dd, _ = st.result_for_tenant(tn)
            digests.append(_check_lists(_host(ii), _host(dd), args.objects,
                                        args.k, res.tick))
        if ranked:
            _same_on_every_rank(digests, res.tick)
    if not lead:
        return 0
    if ranked:
        print(f"[knn] {dist.get_world_size()} ranks ended every tick with "
              f"the same lists for each of {T} tenants", flush=True)
    lifetime = 1 - server.rows_computed / max(server.rows_served, 1)
    if len(walls) > 1:
        print(f"[knn] {T} tenants steady-state: "
              f"{np.median(walls[1:]) * 1e3:.1f} ms/tick, lifetime hit rate "
              f"{lifetime:.2f}")
    return 0


def _host(a) -> np.ndarray:
    """A tenant's lists as numpy (``collect="stats"`` keeps them on the
    device)."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def run_lm(cfg, *, batch: int, prompt_len: int, tokens: int, seed: int,
           device, mesh=None) -> dict:
    """The ``lm`` mode's work for one config: random weights from ``seed``,
    a prefill of ``batch`` random prompts (last-position logits), then
    ``tokens`` greedy decode steps from ``pos = prompt_len`` on an empty
    cache.  Returns the timings, the peak device memory (None on the CPU),
    whether every logit of the prefill and the steps was finite, the
    decoded tokens, and each step's margin between its two largest
    logits.  ``mesh``: a ``DeviceMesh`` of ``("data", "model")`` ranks
    (every rank calls) over which the weights, inputs and decode state are
    laid by the rule tables; the logits are gathered on every rank."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if is_rank_mesh(mesh):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with use_rules(mesh), implicit_replication():
            return _run_lm(cfg, batch, prompt_len, tokens, seed, dev, sync,
                           mesh)
    return _run_lm(cfg, batch, prompt_len, tokens, seed, dev, sync, None)


def _margin(logits) -> torch.Tensor:
    """The gap between each row's two largest logits: (B, 1, V) -> (B,)."""
    top = torch.topk(logits[:, -1, :].float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _run_lm(cfg, batch, prompt_len, tokens, seed, dev, sync, mesh) -> dict:
    cuda = dev.type == "cuda"
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev, mesh=mesh)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len))
    inputs = {"tokens": torch.tensor(prompts, dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.tensor(
            rng.normal(0, 0.02, (batch, prompt_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        inputs["img"] = torch.tensor(
            rng.normal(0, 0.02, (batch, cfg.n_img_tokens, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if mesh is not None:
        inputs = lay_batch(inputs, mesh)

    def token_in(tok):
        if mesh is None:
            return tok
        return lay(tok, current_rules().placements(("batch", None),
                                                   tuple(tok.shape)), mesh)

    # DTensor views do not run under inference mode: no_grad on a mesh
    with torch.inference_mode() if mesh is None else torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, _ = forward(params, cfg, inputs, logits_last_only=True)
        logits = whole(logits)
        tok = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
        sync()
        prefill_s = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        # the reference seeds only the cross-attention memory; the prefill
        # leaves the self-attention caches and recurrent states empty
        state = init_decode_state(cfg, batch, prompt_len + tokens,
                                  mem_len=prompt_len, device=dev)
        if cfg.family == "encdec":
            state = seed_decode_state(
                params, cfg, state,
                encode_memory(params, cfg, inputs["frames"]))
        if cfg.family == "vlm":
            state = seed_decode_state(params, cfg, state, inputs["img"])
        if mesh is not None:
            state = lay_decode_state(state, mesh)
        out, margins = [], []
        sync()
        t0 = time.perf_counter()
        for i in range(tokens):
            logits, state = decode_step(params, cfg, state, token_in(tok),
                                        prompt_len + i)
            logits = whole(logits)
            tok = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
            finite = finite & torch.isfinite(logits).all()
            out.append(tok[:, 0])
            margins.append(_margin(logits))
        sync()
        decode_s = time.perf_counter() - t0
    return {"prefill_s": prefill_s,
            "ms_per_token": decode_s / tokens * 1e3,
            "tok_per_s": batch * tokens / decode_s,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None,
            "finite": bool(finite),
            "tokens": torch.stack(out, 1).cpu().numpy(),
            "margins": torch.stack(margins, 1).cpu().numpy()}


def serve_lm(args, device=None) -> int:
    """The ``lm`` mode: one model on one device, or laid over ``--data`` x
    ``--model`` ranks of a process group of that size (rank 0 prints)."""
    ranked = dist.is_available() and dist.is_initialized()
    world = args.data * args.model
    if world > 1 and (not ranked or dist.get_world_size() != world):
        raise ValueError(
            f"lm: --data {args.data} --model {args.model} lays {world} "
            "ranks; run it under python -m torch.distributed.run "
            f"--nproc-per-node {world}")
    dev = resolve_device(device or args.device)
    mesh = make_local_mesh(data=args.data, model=args.model,
                           device_type=dev.type) if ranked else None
    cfg = config_of(args)
    r = run_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
               tokens=args.tokens, seed=args.seed, device=dev, mesh=mesh)
    if not r["finite"]:
        raise AssertionError(f"lm {args.arch}: a logit is not finite")
    peaks = [r["peak_bytes"]]
    if ranked:
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, r["peak_bytes"])
        if dist.get_rank() != 0:
            return 0
    if args.tokens_out:
        np.savez(args.tokens_out, tokens=r["tokens"], margins=r["margins"],
                 prefill_s=r["prefill_s"], ms_per_token=r["ms_per_token"],
                 tok_per_s=r["tok_per_s"],
                 peak_bytes=np.array(peaks, dtype=np.float64))
    print(f"[lm] prefill {args.batch}x{args.prompt_len}: "
          f"{r['prefill_s']:.2f}s")
    print(f"[lm] decoded {args.tokens} tokens x batch {args.batch}: "
          f"{r['ms_per_token']:.1f} ms/token, {r['tok_per_s']:.1f} tok/s")
    peak = ("not measured (cpu)" if r["peak_bytes"] is None
            else f"{r['peak_bytes']} bytes")
    print(f"[lm] peak device memory: {peak}")
    print("[lm] sample:", r["tokens"][0][:16])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("knn")
    k.add_argument("--objects", type=int, default=50_000)
    k.add_argument("--ticks", type=int, default=10)
    k.add_argument("--k", type=int, default=32)
    k.add_argument("--th-quad", type=int, default=192)
    k.add_argument("--l-max", type=int, default=8)
    k.add_argument("--chunk", type=int, default=8192)
    k.add_argument("--distribution", default="uniform")
    k.add_argument("--plan", default="single")
    k.add_argument("--partitioner", default="equal")
    k.add_argument("--collect", default="full")
    k.add_argument("--maintenance", default="rebuild",
                   choices=["rebuild", "incremental"],
                   help="index maintenance: re-sort every row each tick, or "
                        "splice the moved rows into the live order")
    k.add_argument("--churn", type=float, default=1.0, metavar="F",
                   help="fraction of objects moved per tick; < 1.0 feeds "
                        "only the moved rows as a delta")
    k.add_argument("--tenants", type=int, default=1,
                   help="serve N tenants through one shared KnnServer; "
                        "1 = a solo KnnSession")
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    m = sub.add_parser("lm")
    m.add_argument("--arch", default="rwkv6_3b", choices=list(ARCH_IDS))
    m.add_argument("--smoke", action="store_true")
    m.add_argument("--batch", type=int, default=4)
    m.add_argument("--prompt-len", type=int, default=32)
    m.add_argument("--tokens", type=int, default=16)
    m.add_argument("--data", type=int, default=1,
                   help="data-parallel ranks of the serving mesh")
    m.add_argument("--model", type=int, default=1,
                   help="model-parallel ranks (tensor parallelism by the "
                        "rule tables)")
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    m.add_argument("--tokens-out", default=None,
                   help="save the decoded tokens, each step's margin "
                        "between its two largest logits, the timings and "
                        "every rank's peak device memory (numpy .npz)")
    m.add_argument("--layers", type=int, default=None,
                   help="cut the config to this many layers (n_layers)")
    m.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="parameter and compute dtype (default: the "
                        "config's)")
    args = ap.parse_args(argv)
    if args.mode == "lm" and dist.is_available() and dist.is_initialized():
        return serve_lm(args)
    ranks = init_from_env(args.device)
    if ranks is None:
        return serve_lm(args) if args.mode == "lm" else serve_knn(args)
    dev, backend = ranks
    tag = "lm" if args.mode == "lm" else "knn"
    try:
        if dist.get_rank() == 0:
            print(f"[{tag}] process group: backend={backend} "
                  f"world={dist.get_world_size()}", flush=True)
        print(f"[{tag}] rank {dist.get_rank()} on {dev}", flush=True)
        if args.mode == "lm":
            return serve_lm(args, device=dev)
        return serve_knn(args, device=dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
