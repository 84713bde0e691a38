#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

From the root of a checkout, on a machine with an NVIDIA card::

    python3 knnbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit,
which also close standard error.  Exits non-zero, printing no result, without
enough CUDA cards, and if JAX or the JAX package was loaded.  The port builds
its kernels into ``build/torch_kernels/`` inside the checkout, once.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from knnbench.harness import run_cell

    return run_cell(ROOT / "BENCHMARK.json", args.workload, args.seed,
                    args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
