"""Batched LM serving example: prefill a prompt batch, decode with KV cache /
recurrent state, on the card (or ``--device cpu``); ``--data D --model M``
lays the model over D x M ranks (it starts them under
``torch.distributed.run``: gloo on the CPU or on one shared card).

  PYTHONPATH=src python examples_torch/serve_lm.py [--arch zamba2_7b] [--device cpu] [--model 2]
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2_7b")
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks of the serving mesh")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel ranks (tensor parallelism)")
    args = ap.parse_args(argv)
    world = args.data * args.model
    if world > 1 and "RANK" not in os.environ:
        # one process a rank, each running this script with the same flags
        return subprocess.run([
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(world), __file__,
            *(argv if argv is not None else sys.argv[1:])]).returncode
    return serve.main([
        "lm", "--arch", args.arch, "--smoke", "--batch", "4",
        "--prompt-len", "16", "--tokens", str(args.tokens),
        "--device", args.device, "--data", str(args.data),
        "--model", str(args.model),
    ])


if __name__ == "__main__":
    sys.exit(main())
