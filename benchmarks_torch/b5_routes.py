#!/usr/bin/env python3
"""B5's staged route against its wide template on the same windows.

Run from the repository root on a machine with a CUDA card:

    python3 benchmarks_torch/b5_routes.py [--shapes]

``csrc/bucket_kselect.cu`` picks one route a launch.  To time both sides
of that rule on the same inputs, this script builds a copy of the source
with one more C entry point, which launches the route it is given (the
wide template, or the row loop at one of ``BLOCKS``' block shapes), into
``build/b5_routes/``, and prints ``ptxas``' registers and spills of each
kernel; the package's library is not touched.

- Default: the staged block (10 warps of 2016 kept entries) against the
  wide template at Q = 65,536, C from 4500 to 16,725 (the staged route's
  last window on an H100), k from 256 to 2000: where the staged route
  stops paying in k.
- ``--shapes``: every block shape of ``BLOCKS`` against the template at
  Q = 65,536, C = 16,384, k = 32, 256 and 2000: the staged block's choice.

Each route's output is first held bitwise against the plain version on a
Q = 8192 window with ``chip_smoke.window_inputs``' odd bands, then timed
with CUDA events on the window without them.  The last line is one JSON
object: the card and the times in ms.  Imports nothing of JAX.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (warps a block, kept entries a warp) of the row loop
BLOCKS = ((10, 2016), (9, 2304), (11, 1888), (12, 1728), (8, 2592),
          (7, 2944))
ENTRY = """
namespace {
template <int W, int CAP>
cudaError_t launch_block(const Args& a, int dev) {
  return launch_on<bucket_kselect_kernel<W, CAP>>(a, dev, W,
                                                  loop_bytes(a.c, W, CAP));
}
}  // namespace

extern "C" int bucket_kselect_route_f32(
    const void* qx, const void* qy, const void* px, const void* py,
    const void* valid, void* out, int q, int c, int k, int iters,
    float hi_mul, float hi_add, float tiny, void* stream, int warps,
    int cap) {
  const Args a{static_cast<const float*>(qx), static_cast<const float*>(qy),
               static_cast<const float*>(px), static_cast<const float*>(py),
               static_cast<const bool*>(valid), static_cast<float*>(out),
               q, c, k, iters, hi_mul, hi_add, tiny,
               static_cast<cudaStream_t>(stream)};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warps == 0)
    return static_cast<int>(
        launch_on<bucket_kselect_wide_kernel>(a, dev, kRowsPerBlock, 0));
CASES
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def build():
    """The source with the route entry point, built into build/b5_routes."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "b5_routes"
    out.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(
        f"  if (warps == {w} && cap == {cap})\n"
        f"    return static_cast<int>(launch_block<{w}, {cap}>(a, dev));"
        for w, cap in BLOCKS)
    src = out / "bucket_kselect_routes.cu"
    src.write_text((CSRC / "bucket_kselect.cu").read_text()
                   + ENTRY.replace("CASES", cases))
    lib_path = out / "bucket_kselect_routes.so"
    run = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}{run.stderr}")
    log = (run.stdout + run.stderr).splitlines()
    for at, line in enumerate(log):  # each block shape's registers, spills
        if "Function properties for" in line and "bucket_kselect" in line:
            name = line.rsplit("bucket_kselect", 1)[1][:30]
            print(name, log[at + 1].strip(),
                  log[at + 2].split(":", 1)[1].strip())
    lib = ctypes.CDLL(str(lib_path))
    lib.bucket_kselect_route_f32.restype = ctypes.c_int
    lib.bucket_kselect_route_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_void_p] + [ctypes.c_int] * 2)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", action="store_true",
                    help="time the block shapes at C = 16,384 instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b5_routes: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.fused_scan import HI_ADD, HI_MUL, TINY

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    lib = build()
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)

    def fits(c, w, cap):  # the window, the kept entries, the histograms
        return optin is None or (
            4 * (2 * c + (c + 3) // 4 + w * cap) + 4 * 32 * w <= optin)

    def run(xy, c, k, w, cap):
        out = torch.empty(xy[0].shape[0], device=dev)
        err = lib.bucket_kselect_route_f32(
            *(t.data_ptr() for t in xy), out.data_ptr(), xy[0].shape[0], c,
            k, 4, HI_MUL, HI_ADD, TINY,
            torch.cuda.current_stream().cuda_stream, w, cap)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out

    def planes(qpos, ppos, valid):
        return (qpos[:, 0].contiguous(), qpos[:, 1].contiguous(),
                ppos[:, 0].contiguous(), ppos[:, 1].contiguous(), valid)

    if args.shapes:
        grid = [(16_384, k) for k in (32, 256, 2000)]
        blocks = [(0, 0), *BLOCKS]
    else:
        grid = [(c, k) for c in (4500, 6000, 9000, 12_000, 14_500, 16_384,
                                 16_725)
                for k in (256, 384, 512, 768, 1008, 1500, 2000)]
        blocks = [(0, 0), BLOCKS[0]]
    times = {}
    for c, k in grid:
        odd = cs.window_inputs(8192, c, dev, seed=c + k + 1)
        ref = torch.cat(cs._b5_plain(*odd, k))
        xy = planes(*cs.window_inputs(65536, c, dev, seed=c + k, odd=False))
        for w, cap in blocks:
            if w and not fits(c, w, cap):
                continue
            name = f"C={c} k={k} " + (f"{w}x{cap}" if w else "template")
            if not cs.same_values(run(planes(*odd), c, k, w, cap), ref):
                raise AssertionError(f"{name} != plain version")
            times[name] = cs.time_ms(lambda: run(xy, c, k, w, cap), reps=5,
                                     warmup=2)
            print(f"{name}: {times[name]} ms", flush=True)
    print(json.dumps({"card": card, "q": 65536, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
