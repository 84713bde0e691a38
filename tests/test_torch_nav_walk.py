"""``kernels/nav_walk.py``: the sweep's bounded navigation of one pass.

The CUDA kernel ``csrc/nav_walk.cu`` runs only on the card (its test is in
``test_torch_gpu.py``).  Here a numpy restatement of the kernel's walk, one
row at a time, is held bit for bit against the plain version
``nav_walk_ref`` (the sweep's navigation loop): levels tried from the top
aligned one down, stopping at the first admissible; the pyramid's count read
before the distance; a row leaving the loop as soon as it has found a leaf
or both directions are inactive; int32 cursors that wrap; the distances of
``core/morton.py`` with an exactly rounded fused multiply-add.  And on CPU
tensors ``nav_walk`` runs the plain version and launches nothing.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.pipeline import default_max_nav
from repro_torch.kernels import nav_walk as tnw

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import nav_index, nav_inputs  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _i32(v: int) -> int:
    """``v`` wrapped to a signed 32-bit integer, as int32 tensors wrap."""
    return ((v + 2**31) % 2**32) - 2**31


def _fma32(a, b, c) -> np.float32:
    """Correctly rounded f32 ``a * b + c``: the f64 product is exact, the
    sum is rounded to odd, and the f32 rounding of that is the fma's."""
    p = float(a) * float(b)
    c = float(c)
    s = p + c
    if np.isfinite(s):
        bb = s - p
        err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
        if err != 0:
            bits = int(np.float64(s).view(np.int64))
            if (err > 0) != (s > 0):
                bits -= 1  # toward zero
            s = float(np.int64(bits | 1).view(np.float64))
    return np.float32(s)


def _compact1by1(v: int) -> int:
    v &= 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def _nan_max(a, b):
    """``torch.maximum``: NaN when either operand is."""
    return a if (a > b or a != a) else b


def _dist2(px, py, code, a, ox, oy, cellw):
    z = code & 0xFFFFFFFF
    cx, cy = np.float32(_compact1by1(z)), np.float32(_compact1by1(z >> 1))
    ext = np.float32(1 << a) * cellw
    x0, y0 = _fma32(cx, cellw, ox), _fma32(cy, cellw, oy)
    x1, y1 = x0 + ext, y0 + ext
    zero = np.float32(0)
    dx = _nan_max(_nan_max(x0 - px, px - x1), zero)
    dy = _nan_max(_nan_max(y0 - py, py - y1), zero)
    return _fma32(dy, dy, dx * dx)


def _walk_row(t, row, max_nav):
    """The kernel's walk of one row, in numpy scalars."""
    px, py, kth2, cl, cr, act_l, act_r, next_right, s_cur, e_cur = row
    l_max, n_fine = t["l_max"], 4**t["l_max"]
    pyr_n = len(t["pyramid"])
    clip = lambda v, hi: min(max(v, 0), hi)
    geo = (t["ox"], t["oy"], t["cellw"])
    found_any = False
    for _ in range(max_nav):
        if found_any or not (act_l or act_r):
            break
        right = act_r and (next_right or not act_l)
        cur = cr if right else cl
        if (cur >= n_fine) if right else (cur <= 0):
            if right:
                act_r = False
            else:
                act_l = False
            continue
        cprobe = clip(cur if right else _i32(cur - 1), n_fine - 1)
        a0 = l_max - int(t["leaf_level"][cprobe])
        span0 = 1 << (2 * a0)
        key = cprobe if right else (cprobe >> (2 * a0)) << (2 * a0)
        s = int(t["starts"][clip(key, n_fine - 1)])
        e = int(t["starts"][clip(_i32(key + span0), n_fine)])
        if _i32(e - s) > 0 and _dist2(px, py, key, a0, *geo) <= kth2:
            jump = span0
            s_cur, e_cur = s, e
            next_right = not right
            found_any = True
        else:
            best = a0
            top = l_max if cur == 0 else min(
                l_max, ((cur & -cur).bit_length() - 1) // 2)
            for a in range(top, max(a0, 1) - 1, -1):
                blk = 1 << (2 * a)
                if not (_i32(cur + blk) <= n_fine if right
                        else _i32(cur - blk) >= 0):
                    continue
                lvl_off = ((1 << (2 * (l_max - a))) - 1) // 3
                pidx = cur >> (2 * a) if right else (cur >> (2 * a)) - 1
                ok = t["pyramid"][clip(_i32(lvl_off + pidx), pyr_n - 1)] == 0
                if not ok:
                    code = cur if right else _i32(cur - blk)
                    ok = _dist2(px, py, code, a, *geo) > kth2
                if ok:
                    best = a
                    break
            jump = 1 << (2 * best)
        if right:
            cr = _i32(cur + jump)
        else:
            cl = _i32(cur - jump)
    return cl, cr, act_l, act_r, next_right, s_cur, e_cur, found_any


def _walk(index, rows, max_nav):
    side = np.float32(index.side.item())
    t = {"l_max": index.l_max,
         "leaf_level": index.leaf_level.numpy(),
         "starts": index.starts.numpy(),
         "pyramid": index.pyramid.numpy(),
         "ox": np.float32(index.origin[0].item()),
         "oy": np.float32(index.origin[1].item()),
         "cellw": side / np.float32(1 << index.l_max)}
    cols = [r.numpy() for r in rows]
    out = []
    with np.errstate(all="ignore"):
        for i in range(len(cols[0])):
            row = [c[i] if c.dtype == np.float32 else c[i].item()
                   for c in cols]
            out.append(_walk_row(t, row, max_nav))
    dtypes = (np.int32, np.int32, bool, bool, bool, np.int32, np.int32, bool)
    return [np.array(col, dtype=d) for col, d in zip(zip(*out), dtypes)]


_NAMES = ("cl", "cr", "act_l", "act_r", "next_right", "s", "e", "found")


# (family, its partition's family or None, l_max, objects, rows, side,
# origin): an odd side and origin make cx * cellw + ox round, so the fused
# multiply-add shows; a stale partition leaves empty blocks above leaves
_WORLDS = [
    ("uniform", None, 3, 2000, 512, 1000.3, (-7.3, 3.1)),
    ("gaussian", None, 3, 2000, 512, 1000.3, (-7.3, 3.1)),
    ("gaussian", "uniform", 3, 2000, 512, 1000.3, (-7.3, 3.1)),
    ("uniform", None, 8, 20_000, 256, 22_500.0, (0.0, 0.0)),
    ("gaussian", None, 8, 20_000, 256, 22_500.0, (0.0, 0.0)),
    ("gaussian", "uniform", 8, 20_000, 256, 22_500.0, (0.0, 0.0)),
]


@pytest.mark.parametrize("max_nav", [1, 2, None])
@pytest.mark.parametrize("family,partition,l_max,n_obj,rows,side,origin",
                         _WORLDS)
def test_kernel_walk_equals_plain_navigation(family, partition, l_max, n_obj,
                                             rows, side, origin, max_nav):
    """The kernel's formulation, restated row by row in numpy, equals the
    plain version on every band of ``chip_smoke.nav_inputs`` (NaN and
    infinite coordinates, kth2 inf, 0, NaN and tied, cursors at 0 and
    4^l_max, inactive directions, empty and full leaves) and on every
    output."""
    index = nav_index(family, n_obj, l_max, CPU, seed=l_max, side=side,
                      origin=origin, partition=partition)
    args = nav_inputs(index, rows, CPU, seed=rows + l_max)
    steps = default_max_nav(l_max) if max_nav is None else max_nav
    want = tnw.nav_walk_ref(index, *args, steps)
    got = _walk(index, args, steps)
    for name, g, w in zip(_NAMES, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    if max_nav is None:
        # the bands reach every branch: found, jumped, exhausted, idle
        found, act_l, act_r = want[7], want[2], want[3]
        assert found.any() and (~found & (act_l | act_r)).any()
        assert (~act_l & ~act_r).any()


def test_nav_walk_on_cpu_runs_the_plain_version():
    """CPU tensors: the plain version's outputs, no launch counted on the
    wrapper or in the tick's counters."""
    index = nav_index("gaussian", 3000, 5, CPU, seed=1)
    args = nav_inputs(index, 160, CPU, seed=2)
    before = tnw.nav_walk.launches
    tracing.enable()
    try:
        rec = tracing.open_tick(CPU)
        with tracing.into(rec):
            got = tnw.nav_walk(index, *args, 14)
        trace = tracing.finish(rec)
    finally:
        tracing.disable()
    want = tnw.nav_walk_ref(index, *args, 14)
    for name, g, w in zip(_NAMES, got, want):
        assert torch.equal(g, w), name
    assert tnw.nav_walk.launches == before
    assert trace.counters.get("sweep.nav_launches", 0) == 0


def test_nav_walk_with_no_steps_or_rows_changes_nothing():
    index = nav_index("uniform", 500, 3, CPU)
    args = nav_inputs(index, 32, CPU)
    out = tnw.nav_walk(index, *args, 0)
    for a, o in zip(args[3:], out[:7]):
        assert torch.equal(a, o)
    assert not out[7].any()
    empty = [a[:0] for a in args]
    assert all(o.numel() == 0 for o in tnw.nav_walk(index, *empty, 4))


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros(32, dtype=torch.float64)),  # qx not f32
    (3, torch.zeros(32, dtype=torch.int64)),  # cl not i32
    (5, torch.zeros(32, dtype=torch.uint8)),  # act_l not bool
    (9, torch.zeros(31, dtype=torch.int32)),  # e of another length
    (2, torch.zeros(64, dtype=torch.float32)[::2]),  # kth2 strided
])
def test_nav_walk_refuses_what_the_kernel_does_not_take(which, bad):
    index = nav_index("uniform", 500, 3, CPU)
    args = list(nav_inputs(index, 32, CPU))
    args[which] = bad
    with pytest.raises(ValueError, match="nav_walk"):
        tnw.nav_walk(index, *args, 4)
    with pytest.raises(ValueError, match="max_nav"):
        tnw.nav_walk(index, *nav_inputs(index, 32, CPU), -1)
