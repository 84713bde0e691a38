#!/usr/bin/env python3
"""Which part of a laid MoE block's backward runs on 2 ranks of the card.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/moe_tp_probe.py [--regions block router ...]

Each region of ``repro_torch.models.moe.moe_ffn`` (granite-sized smoke
MoE, 8 experts, top 2, on a ``(data, model) = (1, 2)`` mesh of 2 gloo
ranks sharing the card) runs forward and backward alone, its inputs
leaves, in a ``torch.distributed.run`` of its own, so that a fault in one
leaves the others to report: ``router`` (the laid einsum), ``route`` (the
slot tables), ``dispatch``, ``experts``, ``combine``, ``aux`` (the
load-balance loss), ``chain`` (routing into the combine through the gate
table laid out on ``expert`` by ``constrain``: its backward gathers along
dimension 1, which faults under torch 2.11 with gloo on CUDA tensors, so
``moe_ffn`` keeps the gate table whole and slices it in the combine) and
``block`` (the whole ``moe_ffn``).  A region that faults prints its
Python stack (``faulthandler``).  Prints one JSON
line: each region's exit code, with the card's name and power limit.
Exits non-zero without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
REGIONS = ("router", "route", "dispatch", "experts", "combine", "aux",
           "chain", "block")
B, S, D, FF, E, TOP = 4, 16, 64, 32, 8, 2


def _rank(region: str) -> int:
    """One rank: the region's forward and backward."""
    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.models.moe as moe
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import constrain, distribute_leaf, einsum, use_rules
    from repro_torch.launch.mesh import init_from_env, make_local_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import Init

    dev, _ = init_from_env("cuda")
    mesh = make_local_mesh(data=1, model=2, device_type="cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cap = int(max(1, round(S * TOP / E * 1.25)))
    with use_rules(mesh) as lr, implicit_replication():
        p = moe.init_moe(Init(g, dev), D, FF, E, torch.float32)
        p = {k: distribute_leaf(v, moe.moe_logical()[k], mesh)
             .requires_grad_(True) for k, v in p.items()}
        x = distribute_leaf(torch.randn(B, S, D, device=dev, generator=g),
                            ("batch", None, None), mesh).requires_grad_(True)
        rows = lr.placements(("batch", None, None), (B, S, E))
        slots = lr.placements(("batch", None), (B, E * cap))
        expert = ("batch", "expert", "expert_cap")

        def routed(probs):
            return moe._local(lambda q: moe._route(q, TOP, cap),
                              (slots, slots))(probs.redistribute(mesh, rows))

        probs = torch.softmax(einsum("bsd,de->bse", x.detach().float(),
                                     p["router"].detach().float()), -1)
        inv, gate = routed(probs.detach().requires_grad_(True))
        inv3 = constrain(inv.detach().reshape(B, E, cap), expert)
        gate3 = constrain(gate.detach().reshape(B, E, cap), expert)
        if region == "router":
            out = einsum("bsd,de->bse", x.float(), p["router"].float())
        elif region == "route":
            out = routed(probs.detach().requires_grad_(True))[1]
        elif region == "dispatch":
            grad = moe._partial_where_sharded(x.placements, inv3.placements)
            out = moe._local(moe._dispatch, (inv3.placements,),
                             in_grad_placements=(grad, inv3.placements))(
                                 x, inv3)
        elif region in ("experts", "combine"):
            ye = distribute_leaf(torch.randn(B, E, cap, D, device=dev),
                                 (*expert, None), mesh).requires_grad_(True)
            if region == "experts":
                pl = [Shard(0) if q.is_shard(1) else Replicate()
                      for q in ye.placements]
                grad = tuple(w if not q.is_shard() or q.is_shard(1)
                             else Partial()
                             for w, q in zip(pl, ye.placements))
                ws = [p[k].redistribute(mesh, tuple(pl))
                      for k in ("w_in", "w_gate", "w_out")]
                out = moe._local(moe._experts, (ye.placements,),
                                 in_grad_placements=(ye.placements,)
                                 + (grad,) * 3)(ye, *ws)
            else:
                gate3 = gate3.requires_grad_(True)
                pl = moe._partial_where_sharded(
                    lr.placements(("batch", None, None), (B, S, D)),
                    inv3.placements)
                out = moe._local(lambda a, b, c: moe._combine(a, b, c, S),
                                 (pl,))(ye, inv3, gate3)
        elif region == "aux":
            cfg = dataclasses.replace(get_smoke_config(
                "granite_moe_3b_a800m"), n_experts=E, top_k=TOP)
            out = model_mod._load_balance_loss(
                einsum("bsd,de->bse", x.float(), p["router"].float()), cfg)
        elif region == "chain":
            inv, gate = routed(probs.detach().requires_grad_(True))
            gate3 = constrain(gate.reshape(B, E, cap), expert)
            ye = distribute_leaf(torch.randn(B, E, cap, D, device=dev),
                                 (*expert, None), mesh)
            pl = moe._partial_where_sharded(
                lr.placements(("batch", None, None), (B, S, D)),
                inv3.placements)
            out = moe._local(lambda a, b, c: moe._combine(a, b, c, S),
                             (pl,))(ye, inv3, gate3)
        else:
            y, logits = moe.moe_ffn(p, x, n_experts=E, top_k=TOP)
            out = y.sum() + logits.sum()
        out.sum().backward()
    print(f"{region}: ok", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regions", nargs="*", default=list(REGIONS),
                    choices=REGIONS)
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_tp_probe: no CUDA device is available", file=sys.stderr)
        return 1
    if args.rank:
        return _rank(args.rank)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    rcs = {}
    for region in args.regions:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", __file__, "--rank", region],
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=300)
        rcs[region] = r.returncode
        if r.returncode:
            print("\n".join(ln for ln in r.stdout.splitlines()
                            + r.stderr.splitlines()
                            if "File " in ln or "Fatal" in ln)[-3000:])
    print(json.dumps({"regions": rcs, "torch": torch.__version__,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
