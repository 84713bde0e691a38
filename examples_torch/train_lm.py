"""Train a (reduced) assigned-architecture LM with the full substrate:
AdamW, the deterministic data pipeline, checkpointing, and a
simulated-failure restart demonstrating fault tolerance, on the card (or
``--device cpu``); ``--data D --model M`` runs both phases on D x M ranks
under ``torch.distributed.run`` (tensor parallelism for M > 1).

  PYTHONPATH=src python examples_torch/train_lm.py [--arch rwkv6_3b] [--steps 30] [--device cpu] [--model 2]
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel ranks (tensor parallelism)")
    args = ap.parse_args(argv)

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    world = args.data * args.model
    ranks = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", str(world)] if world > 1
             else [sys.executable])
    base = [
        *ranks, "-m", "repro_torch.launch.train", "--arch", args.arch,
        "--smoke", "--steps", str(args.steps), "--batch", "8", "--seq", "64",
        "--ckpt-dir", ckpt, "--ckpt-every", "10", "--log-every", "5",
        "--device", args.device, "--data", str(args.data),
        "--model", str(args.model),
    ]
    crash = args.steps // 2 + 1
    try:
        print("=== phase 1: train, then crash at step", crash, "===",
              flush=True)
        r = subprocess.run(base + ["--simulate-failure", str(crash)],
                           env=env)
        print("exit code:", r.returncode, "(simulated failure)", flush=True)
        # torch.distributed.run reports a rank's exit as its own failure
        if r.returncode != 42 and (world == 1 or r.returncode == 0):
            return 1
        print("=== phase 2: restart --resume from the last checkpoint ===",
              flush=True)
        r = subprocess.run(base + ["--resume"], env=env)
        if r.returncode != 0:
            return r.returncode
        print("=== done: training survived a mid-run failure ===", flush=True)
        return 0
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
