"""Training driver of the LM harness, in PyTorch (one device, or
data-parallel ranks under ``torch.distributed.run``).

Counterpart of ``repro/launch/train.py``, with its flags and log lines.
Fault tolerance: checkpoints every ``--ckpt-every`` steps (atomic commit);
``--resume`` restores the latest checkpoint and replays the step-indexed
data pipeline from there, so a resumed run ends on the uninterrupted run's
bits.  ``--simulate-failure N`` exits 42 after step N, before its
checkpoint.  ``--data N`` shares each batch among N ranks of a process
group (gloo on the CPU or on one shared card, NCCL where every rank has a
card of its own), each holding the whole model; ``--model M`` lays the
model over M ranks by the rule tables (tensor parallelism,
``train.make_train_step``), ``--data D --model M`` over a D x M mesh
(``embed`` on ``data`` too).  A laid run's checkpoints hold the gathered
tree, so a ``--model 2`` run resumes on one rank and the other way round.
Runs on the card unless ``--device cpu``; ``--metrics PATH`` writes each
step's loss, grad norm and seconds and a summary (parameter count, peak
device memory of every rank, the leaves that moved, of all and of those
not constant at the start, the bytes a rank holds and the leaves laid on
``model``) as JSON lines.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_3b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt --resume [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --smoke --data 2
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --smoke --data 2 \\
      --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.lm import LMDataConfig, SyntheticLMData
from ..dist import full_tree, local_bytes
from ..models import init_params
from ..runtime import resolve_device
from ..train import (OptConfig, init_opt, make_train_step, restore_latest,
                     save_checkpoint)
from ..train.optimizer import _slices, tree_leaves
from ..train.step import laid as laid_mesh
from .mesh import init_from_env, make_local_mesh


def config_of(args):
    """The run's config: ``--smoke`` or full, cut to ``--layers``, in
    ``--dtype``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    return cfg


def _save(directory, step, params, opt, cfg, lead: bool):
    """A checkpoint of the gathered tree (every rank gathers; the lead
    writes)."""
    tree = full_tree({"params": params, "opt": opt})
    if lead:
        save_checkpoint(directory, step, tree, extra={"arch": cfg.arch_id})


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _checksums(params) -> list:
    """One f64 sum a leaf (slice by slice; a laid leaf's shard on this
    rank): whether a leaf moved."""
    return [sum(float(torch.sum(s, dtype=torch.float64))
                for s in _slices(_local(p))) for p in tree_leaves(params)]


def _moved(before, after, ranked: bool) -> list:
    """Whether each leaf moved, on any rank."""
    moved = [a != b for a, b in zip(before, after)]
    if ranked:
        flags = torch.tensor(moved, dtype=torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        moved = [bool(f) for f in flags]
    return moved


def _constant(params) -> list:
    """Whether each leaf holds one value (a norm scale, a zero bias): in
    bf16 such a leaf at 1.0 stays put under steps below half its ulp."""
    out = []
    for p in tree_leaves(params):
        same = p.min() == p.max()
        out.append(bool(same.full_tensor() if isinstance(same, DTensor)
                        else same))
    return out


def _model_split(params, mesh) -> tuple[int, int]:
    """(leaves laid on ``model``, of them those whose shard on this rank
    is their size over the ranks of the mesh dimensions that shard them,
    ``model`` among them)."""
    i = list(mesh.mesh_dim_names).index("model")
    n = m = 0
    for p in tree_leaves(params):
        if isinstance(p, DTensor) and p.placements[i].is_shard():
            n += 1
            ways = 1
            for j, q in enumerate(p.placements):
                ways *= mesh.size(j) if q.is_shard() else 1
            m += p.to_local().numel() * ways == p.numel()
    return n, m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_3b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks (a process group of that size)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel ranks (tensor parallelism by the "
                         "rule tables)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    ap.add_argument("--metrics", default=None,
                    help="write per-step metrics and a summary (JSON lines)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (n_layers)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="parameter and compute dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    own_group = False
    if not dist.is_initialized():
        ranks = init_from_env(args.device)
        if ranks is not None:
            dev, own_group = ranks[0], True
    try:
        return train(args, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def train(args, dev) -> int:
    ranked = dist.is_initialized()
    world = args.data * args.model
    if world > 1 and not ranked:
        raise ValueError(
            f"train: --data {args.data} --model {args.model} needs a process "
            f"group of {world} ranks (python -m torch.distributed.run "
            f"--nproc-per-node {world} ...)")
    # a laid model's DTensors live on the run's device
    mesh = make_local_mesh(
        data=args.data, model=args.model,
        device_type=dev.type if args.model > 1 else None) if ranked else None
    laid = laid_mesh(mesh)
    lead = not ranked or dist.get_rank() == 0
    cfg = config_of(args)
    data = SyntheticLMData(
        LMDataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                     seed=args.seed))
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (args.seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["img"] = (cfg.n_img_tokens, cfg.d_model)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev, mesh=mesh if laid else None)
    opt = init_opt(params)
    start = 0
    if args.resume and args.ckpt_dir:
        # a laid leaf restores whole, then keeps this rank's shard
        restored, step = restore_latest(args.ckpt_dir,
                                        {"params": params, "opt": opt})
        if restored is not None:
            del params, opt
            params, opt = restored["params"], restored["opt"]
            start = step
            if lead:
                print(f"[train] resumed from step {start}", flush=True)

    log = open(args.metrics, "w") if args.metrics and lead else None
    # a laid run's summary reduces over the ranks: every rank tracks
    track = bool(args.metrics) and (lead or laid)
    before = _checksums(params) if track else None
    constant = _constant(params) if track else None
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum, mesh=mesh)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.tensor(v, device=dev)
                 for k, v in data.batch_for_step(step, extras).items()}
        t_step = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        if log:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            log.write(json.dumps({"step": step + 1, "loss": loss,
                                  "grad_norm": gnorm,
                                  "s": time.perf_counter() - t_step}) + "\n")
        if args.simulate_failure is not None and step + 1 == \
                args.simulate_failure:
            # hard crash AFTER the step, BEFORE its checkpoint
            print(f"[train] simulated failure at step {step + 1}", flush=True)
            sys.exit(42)
        if (step + 1) % args.ckpt_every == 0 and args.ckpt_dir:
            _save(args.ckpt_dir, step + 1, params, opt, cfg, lead)
        if (step + 1) % args.log_every == 0 and lead:
            print(f"[train] step {step + 1} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / max(step + 1 - start, 1):.2f}"
                  "s/step)", flush=True)
    if args.ckpt_dir:
        _save(args.ckpt_dir, args.steps, params, opt, cfg, lead)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    peaks = [peak]
    if ranked:
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
    if track:
        moved = _moved(before, _checksums(params), laid)
        split = _model_split(params, mesh) if laid else (0, 0)
    if log:
        log.write(json.dumps({
            "summary": True, "arch": cfg.arch_id, "n_params": cfg.n_params(),
            "tree_params": sum(p.numel() for p in tree_leaves(params)),
            "param_dtype": cfg.param_dtype, "remat": cfg.remat,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "compute_dtype": cfg.compute_dtype,
            "vocab": cfg.vocab, "batch": args.batch, "seq": args.seq,
            "steps": args.steps - start, "device": str(dev),
            "peak_bytes": peak, "peak_bytes_ranks": peaks,
            "mesh": {"data": args.data, "model": args.model},
            "local_bytes": local_bytes(params) + local_bytes(opt),
            "model_leaves": split[0], "model_leaves_split": split[1],
            "leaves": len(moved), "leaves_moved": sum(moved),
            "random_leaves": constant.count(False),
            "random_leaves_moved": sum(m for m, c in zip(moved, constant)
                                       if not c),
            "seconds": time.time() - t0}) + "\n")
        log.close()
    if ranked:
        dist.barrier()
    if lead:
        print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
