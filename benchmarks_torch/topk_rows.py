#!/usr/bin/env python3
"""B4 (``topk_select``) by row type, beside ``torch.topk`` on the same rows.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/topk_rows.py

At each shape of ``kernel_ab.B4_WIDE`` (the radix select) and the two warp
queue shapes (C = 288 and 2048, k = 32), times the kernel on Q rows all of
one type: ``chip_smoke.topk_inputs`` with ``odd_values``' bands as the
records of ``chip_smoke.py`` have them (``bands``), uniform random
distances (``uniform``), each of the edge bands alone (every row a copy of
that band's rows: ties on a grid, one d2 for the row, exact duplicates,
fewer than k finite entries, every entry +inf), and ``worst_rows``'
``equal`` rows.  Each output is first held bit for bit against
``masked_argmin_rounds`` (in row blocks).  The last line is one JSON
object: the card and, per shape and row type, the kernel's and
``torch.topk``'s times in ms.  Imports nothing of JAX.  Exits non-zero
without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# topk_inputs' band index of each edge band timed alone
BANDS = {"ties": 0, "fewfin": 3, "allinf": 4, "dups": 5, "oned2": 7}


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_rows: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "benchmarks_torch")]
    import chip_smoke as cs
    from kernel_ab import B4_WIDE
    from repro_torch.kernels import build
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.refine import masked_argmin_rounds

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    build.build_all()
    times = {}
    for q, c, k in ((1_000_000, 288, 32), (8192, 2048, 32), *B4_WIDE):
        d, ids = cs.topk_inputs(q, c, k, dev, seed=c + k)
        d = cs.odd_values(d)
        e = q // 16
        g = torch.Generator(device=dev).manual_seed(c)
        rows = {"bands": (d, ids),
                "uniform": (torch.rand((q, c), generator=g, device=dev)
                            * 4.0e6, ids)}
        for name, b in BANDS.items():
            pick = b * e + torch.arange(q, device=dev) % e
            rows[name] = (d[pick].contiguous(), ids[pick].contiguous())
        rows["equal"] = cs.worst_rows(q, c, "equal", dev, seed=c)
        line = {}
        for name, (dd, ii) in rows.items():
            cs._check_lists(
                f"B4 Q={q} C={c} k={k} {name} rows != plain version",
                tk.topk_select(dd, ii, k=k),
                cs._in_blocks(lambda a, b: masked_argmin_rounds(a, b, k),
                              (dd, ii), blk=65536 if c < 1024 else 2048))
            line[name] = {
                "ms": cs.time_ms(lambda: tk.topk_select(dd, ii, k=k),
                                 reps=10),
                "topk_ms": cs.time_ms(
                    lambda: torch.topk(dd, k, dim=1, largest=False),
                    reps=10)}
        shape = f"Q={q} C={c} k={k}"
        times[shape] = line
        print(shape + ": " + ", ".join(
            f"{n} {t['ms']:.4f} (torch.topk {t['topk_ms']:.4f})"
            for n, t in line.items()), flush=True)
        del d, ids, rows
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
