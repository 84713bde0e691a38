"""Batched LM serving example: prefill a prompt batch, decode with KV cache /
recurrent state, on the card (or ``--device cpu``).

  PYTHONPATH=src python examples_torch/serve_lm.py [--arch zamba2_7b] [--device cpu]
"""
import argparse
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
    args = ap.parse_args(argv)
    return serve.main([
        "lm", "--arch", args.arch, "--smoke", "--batch", "4",
        "--prompt-len", "16", "--tokens", str(args.tokens),
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
