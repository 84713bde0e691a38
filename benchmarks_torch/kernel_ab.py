#!/usr/bin/env python3
"""Times of one source tree's B1-B5 kernels on this checkout's inputs.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/kernel_ab.py [--tree DIR] [--ptxas]

``repro_torch`` is imported from ``DIR/src`` (default: this checkout) and its
kernels are built into ``DIR/build/torch_kernels``; ``--ptxas`` prints nvcc's
register and spill report of that build.  The inputs are this checkout's
``chip_smoke.py`` inputs without the NaN and negative bands (``odd=False``),
made by the plain versions of the tree under test, so two trees whose plain
versions agree time the same work:

- B1 ``fused_scan_merge``, fp32 and mixed, W = 256, k = 32, at Q = 8192 and
  Q = 1,007,616 (the 1M path's first trip); and past the narrow row at
  Q = 8192: W = 1024, k = 32; W = 256, k = 512; W = 256, k = 384;
- B3 ``merge_topk_lists`` past the narrow row, ka = kb = k = 384, and B2
  ``merge_topk_multi`` past it, R = 8, k = 128, at Q = 65,536 on
  ``merge_inputs``' edge rows;
- B5 ``bucket_kselect``, Q = 1,000,000 against one window of C = 2048, at
  k = 32 and 256;
- B4 ``topk_select``, k = 32, at Q = 1,000,000, C = 288 and Q = 8192,
  C = 2048 (the warp queue); and beside one ``torch.topk`` call on the same
  distances, at the shapes past the queue: C = 8192, k = 32 (Q = 8192);
  C = 40,000, k = 32 (Q = 2048); C = 3000, k = 300 (Q = 8192); C = 8192,
  k = 512 (Q = 2048); C = 12,000, k = 600 (Q = 2048); C = 2048, k = 512
  (Q = 8192).

Each kernel's output is first held bit for bit against its plain version
(in row blocks), then timed with CUDA events (B1 at Q = 8192 in CUDA
graphs: its kernel is shorter than the wrapper's Python).  To compare two trees, run
them in turns in one call on one card (parent, change, change, parent).
The last line is one JSON object: the tree, the card and the times in ms.
Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (Q, C, k) of B4 past its warp queue, timed beside torch.topk
B4_WIDE = ((8192, 8192, 32), (2048, 40_000, 32), (8192, 3000, 300),
           (2048, 8192, 512), (2048, 12_000, 600), (8192, 2048, 512))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="the source tree whose kernels are timed")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and spill report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import bucket_kselect as bk
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import merge_topk as mt
    from repro_torch.kernels import topk_select as tk
    from repro_torch.kernels.refine import masked_argmin_rounds

    if not fs.__file__.startswith(str(tree)):
        raise RuntimeError(f"repro_torch came from {fs.__file__}, not {tree}")
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"tree {tree}\n{card}")
    build.build_all(verbose=args.ptxas)
    times = {}

    k, w = 32, 256
    for q in (8192, 1_007_616):
        base = cs.kernel_inputs(q, w, k, dev, odd=False)
        for label, kw in (("fp32", dict(k=k)),
                          ("mixed", dict(k=k, precision="mixed"))):
            cs._check_lists(
                f"B1 {label} Q={q} != plain version",
                fs.fused_scan_merge(*base, **kw),
                cs._in_blocks(lambda *b: fs.fused_scan_merge_ref(*b, **kw),
                              base))
            run = lambda: fs.fused_scan_merge(*base, **kw)
            times[f"B1 {label} Q={q}"] = (cs.time_graph_ms(run) if q <= 8192
                                          else cs.time_ms(run, reps=10))
        del base

    for w, kk in ((1024, 32), (256, 512), (256, 384)):
        base = cs.kernel_inputs(8192, w, kk, dev, seed=w + kk, odd=False)
        for label, kw in (("fp32", dict(k=kk)),
                          ("mixed", dict(k=kk, precision="mixed"))):
            cs._check_lists(f"B1 wide {label} W={w} k={kk} != plain version",
                            fs.fused_scan_merge(*base, **kw),
                            fs.fused_scan_merge_ref(*base, **kw))
            times[f"B1 wide {label} W={w} k={kk}"] = cs.time_graph_ms(
                lambda: fs.fused_scan_merge(*base, **kw))
        del base

    q, r = 65536, 8
    d, i = cs.merge_inputs(r, q, 128, dev, seed=8, inf_ids=True)
    cat = (d.transpose(0, 1).reshape(q, r * 128).contiguous(),
           i.transpose(0, 1).reshape(q, r * 128).contiguous())
    d, i = cs.merge_inputs(2, q, 384, dev, seed=9, inf_ids=True)
    lists = (d[0], i[0], d[1], i[1])
    del d, i
    for name, fn, plain, a, kk in (
            ("B2 wide R=8 k=128", mt.merge_topk_multi,
             mt.merge_topk_multi_ref, cat, 128),
            ("B3 wide k=384", mt.merge_topk_lists, mt.merge_topk_lists_ref,
             lists, 384)):
        cs._check_lists(f"{name} != plain version", fn(*a, k=kk),
                        plain(*a, k=kk))
        times[name] = cs.time_ms(lambda: fn(*a, k=kk), reps=20)
    del cat, lists

    qpos, ppos, valid = cs.window_inputs(1_000_000, 2048, dev, seed=5,
                                         odd=False)
    xy = (qpos[:, 0].contiguous(), qpos[:, 1].contiguous(),
          ppos[:, 0].contiguous(), ppos[:, 1].contiguous(), valid)
    for kk in (32, 256):
        out = bk.bucket_kselect(*xy, k=kk)
        ref = cs._in_blocks(
            lambda qx, qy: (bk.bucket_kselect_ref(qx, qy, *xy[2:], k=kk),),
            xy[:2])[0]
        if not cs.same_values(out, ref):
            raise AssertionError(f"B5 k={kk} != plain version")
        times[f"B5 k={kk}"] = cs.time_ms(lambda: bk.bucket_kselect(*xy, k=kk),
                                         reps=5)
    del qpos, ppos, valid, xy

    for i, (q, c) in enumerate(((1_000_000, 288), (8192, 2048))):
        d, ids = cs.topk_inputs(q, c, k, dev, seed=4 + i)
        cs._check_lists(f"B4 C={c} != plain version",
                        tk.topk_select(d, ids, k=k),
                        cs._in_blocks(lambda a, b: masked_argmin_rounds(a, b,
                                                                        k),
                                      (d, ids)))
        times[f"B4 C={c}"] = cs.time_ms(lambda: tk.topk_select(d, ids, k=k),
                                        reps=20)
        del d, ids
    for q, c, kk in B4_WIDE:
        d, ids = cs.topk_inputs(q, c, kk, dev, seed=c + kk)
        cs._check_lists(f"B4 C={c} k={kk} != plain version",
                        tk.topk_select(d, ids, k=kk),
                        cs._in_blocks(lambda a, b: masked_argmin_rounds(
                            a, b, kk), (d, ids), blk=2048))
        times[f"B4 C={c} k={kk}"] = cs.time_ms(
            lambda: tk.topk_select(d, ids, k=kk), reps=20)
        times[f"torch.topk C={c} k={kk}"] = cs.time_ms(
            lambda: torch.topk(d, kk, dim=1, largest=False), reps=20)
        del d, ids
    for name, ms in times.items():
        print(f"{name}: {ms} ms")
    print(json.dumps({"tree": str(tree), "card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
