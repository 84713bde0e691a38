#!/usr/bin/env python3
"""The control of the check: the plain reference in bfloat16, put in the
program's place, has to come out as not correct.

The configurations state float32; bfloat16 is the next precision below it.
For each seed this makes the cell's traffic as a run does, takes the ticks a
window plays first and in each the rows a run samples, answers them with the
bfloat16 reference, and hands those answers to the run's own comparison
(``check.compare``), whose verdict has to be ``correct`` false.
The benchmark's own runs never run it.  On the card, at the cell's size::

    python3 knnbench/control.py --workload uniform_1m.move_all \\
        --seeds 11 12 13 --ticks 20

prints one JSON line per seed.  Imports nothing of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(manifest: Path, workload: str, seed: int, ticks: int,
                    device) -> dict:
    """The checks of the bfloat16 reference over ``ticks`` window ticks."""
    import torch

    from knnbench import check
    from knnbench.harness import WARM_TICKS, Cell
    from knnbench.traffic import Traffic

    cell = Cell(Path(manifest), workload)
    k = int(cell.config["spec"]["k"])
    traffic = Traffic(cell.config["data"], cell.mix, seed,
                      cell.config["check"]["rows_per_tick"])
    first = 1 + WARM_TICKS  # the window's first step
    answers, last = {}, None
    t0 = time.perf_counter()
    for step, pos in traffic.held_positions(range(first, first + ticks)):
        rows = traffic.sample_rows(step)
        pts = torch.as_tensor(pos, device=device)
        sel = torch.as_tensor(rows, device=device)
        got_i, got_d = cell.reference.knn(pts, pts[sel], sel, k,
                                          precision="bf16")
        answers[step] = (rows, got_i.cpu().numpy(), got_d.cpu().numpy())
        last = (pos.copy(), pos[rows], rows, *answers[step][1:])
    checks, rows_checked = check.compare(cell.reference, traffic, answers,
                                         last, k, device)
    return {"workload": workload, "seed": seed, "control": "bf16 reference",
            "correct": check.correct(checks), "rows_checked": rows_checked,
            "ticks": ticks, "seconds": time.perf_counter() - t0,
            "checks": checks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(control_reading(ROOT / "BENCHMARK.json",
                                         args.workload, seed, args.ticks,
                                         torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
