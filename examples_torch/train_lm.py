"""Train a (reduced) assigned-architecture LM with the full substrate:
AdamW, the deterministic data pipeline, checkpointing, and a
simulated-failure restart demonstrating fault tolerance, on the card (or
``--device cpu``).

  PYTHONPATH=src python examples_torch/train_lm.py [--arch rwkv6_3b] [--steps 30] [--device cpu]
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
    args = ap.parse_args(argv)

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [
        sys.executable, "-m", "repro_torch.launch.train", "--arch", args.arch,
        "--smoke", "--steps", str(args.steps), "--batch", "8", "--seq", "64",
        "--ckpt-dir", ckpt, "--ckpt-every", "10", "--log-every", "5",
        "--device", args.device,
    ]
    crash = args.steps // 2 + 1
    try:
        print("=== phase 1: train, then crash at step", crash, "===",
              flush=True)
        r = subprocess.run(base + ["--simulate-failure", str(crash)],
                           env=env)
        print("exit code:", r.returncode, "(simulated failure)", flush=True)
        if r.returncode != 42:
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
