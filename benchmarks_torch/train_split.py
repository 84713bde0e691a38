#!/usr/bin/env python3
"""Where a full-width training step's time and gradient norm go, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/train_split.py [--arch rwkv6_3b] [--steps 4]

Builds the launcher's state (``init_params`` seeded 0 on the card, the
launcher's ``OptConfig``, ``SyntheticLMData`` batches of 8 x 128) at full
width and depth and runs ``--steps`` steps of the train step's parts, each
timed on the host clock between CUDA synchronisations: the loss and its
gradients (``grads_and_loss``), the global norm, the AdamW update.  Then
one more step under ``torch.profiler``: device time by kernel and the
device's busy share of the step.  Step 1's gradient norm by leaf (the
largest), and at a 2-layer cut of the same width the step-1 gradient norms
in f32 beside bf16 from the same draws (whether the early norms are the
init's or bf16's).  Prints one JSON line with the card's name and power
limit.  Exits non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

import common

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _leaf_norms(grads) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            out[path] = float(torch.linalg.vector_norm(t.float()))

    walk(grads, "")
    return out


def _state(cfg, dev):
    from repro_torch.models import init_params
    from repro_torch.train import init_opt

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return params, init_opt(params)


def _batch(cfg, step: int, dev) -> dict:
    from repro_torch.data.lm import LMDataConfig, SyntheticLMData

    data = SyntheticLMData(LMDataConfig(vocab=cfg.vocab, batch=8,
                                        seq_len=128, seed=0))
    return {k: torch.tensor(v, device=dev)
            for k, v in data.batch_for_step(step).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_split: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, global_norm, grads_and_loss
    from repro_torch.train.optimizer import _clip_scale, adamw_step_

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5)  # the launcher's
    params, opt = _state(cfg, dev)
    tree_params = sum(p.numel() for p in _leaves(params))
    steps, norms = [], None

    def one_step(i):
        nonlocal params, opt
        b = _batch(cfg, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = grads_and_loss(params, cfg, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gn = global_norm(grads)
        scale = _clip_scale(gn, opt_cfg.clip_norm)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt = adamw_step_(params, grads, opt, opt_cfg, scale)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return loss, grads, gn, (t1 - t0, t2 - t1, t3 - t2)

    for i in range(args.steps):
        loss, grads, gn, (fb, nrm, upd) = one_step(i)
        if i == 0:
            norms = _leaf_norms(grads)
        steps.append({"step": i + 1, "loss": float(loss),
                      "grad_norm": float(gn), "loss_and_grads_s": fb,
                      "global_norm_s": nrm, "update_s": upd})
        del grads
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(args.steps)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    peak = torch.cuda.max_memory_allocated(dev)
    del params, opt
    torch.cuda.empty_cache()
    cut = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, n_layers=2, param_dtype=dtype,
                                compute_dtype=dtype)
        p, _ = _state(c, dev)
        loss, grads = grads_and_loss(p, c, _batch(c, 0, dev))
        cut[dtype] = {"loss": float(loss),
                      "grad_norm": float(global_norm(grads)),
                      "leaf_norms": _leaf_norms(grads)}
        del p, grads
        torch.cuda.empty_cache()
    big = sorted(norms.items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({
        "arch": args.arch, "config_n_params": cfg.n_params(),
        "tree_params": tree_params, "batch": 8, "seq": 128,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat, "steps": steps,
        "profiled_step": {"wall_s": wall, "device_busy_s": busy,
                          "device_busy_share": busy / wall,
                          "top_kernels": [
                              {"name": e.key[:80],
                               "device_s": e.self_device_time_total / 1e6,
                               "calls": e.count} for e in top]},
        "step1_largest_leaf_grad_norms": dict(big),
        "cut_2_layers_step1": {
            k: {"loss": v["loss"], "grad_norm": v["grad_norm"],
                "largest": dict(sorted(v["leaf_norms"].items(),
                                       key=lambda kv: -kv[1])[:4])}
            for k, v in cut.items()},
        "peak_bytes": peak, "card": common.card_line()}))
    return 0


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves

    return tree_leaves(tree)


if __name__ == "__main__":
    sys.exit(main())
