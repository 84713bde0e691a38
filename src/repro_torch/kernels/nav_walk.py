"""The sweep's bounded navigation of one pass, as one CUDA kernel.

Replaces no Pallas kernel: it is the body of the reference's ``nav_body``
``lax.fori_loop`` and its inner ``try_level`` ``fori_loop``
(``repro/core/pipeline.py:281`` and ``:158``), which XLA compiles in line.
Eager PyTorch ran that body as :func:`nav_walk_ref`: ``max_nav`` steps a
pass of about 150 small operations each, dispatched one by one from the
host.  The hand-written kernel ``csrc/nav_walk.cu`` runs one thread a
navigating row and walks its steps with the row's whole state in registers
(see the source's header for the design).  Bound on an H100: memory and
dependent L2 probes — a row reads 31 bytes and writes 20, 51 MB at 1M rows,
about 15 us at 3.35 TB/s; the tables it probes stay in L2.

:func:`nav_walk` launches the kernel for CUDA tensors (or raises) and runs
:func:`nav_walk_ref` for CPU tensors; its outputs equal the plain version's
bit for bit.  ``nav_walk.launches`` counts kernel launches, and each launch
adds one to the tracing counter ``sweep.nav_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..core import morton

__all__ = ["nav_walk", "nav_walk_ref"]


def _nav_step(index, qx, qy, kth2, cursor, run, dir_r, levels):
    """One navigation step; ``dir_r`` is a per-query bool (True = rightwards).

    Returns (found, s, e, new_cursor, exhausted) as the reference does.  The
    reference's rolled loop over jump levels ``a = 1..l_max`` is evaluated for
    all levels at once on a (Q, l_max) tensor: the largest admissible level
    wins, and ``a0`` when none is.
    """
    l_max = index.l_max
    n_fine = 4**l_max

    exhausted = torch.where(dir_r, cursor >= n_fine, cursor <= 0)
    cprobe = torch.where(dir_r, cursor, cursor - 1).clamp(0, n_fine - 1)

    lvl = index.leaf_level[cprobe]
    a0 = l_max - lvl
    span0 = torch.bitwise_left_shift(torch.ones_like(a0), 2 * a0)
    leaf_key = torch.where(dir_r, cprobe, (cprobe >> (2 * a0)) << (2 * a0))
    s = index.starts[leaf_key.clamp(0, n_fine - 1)]
    e = index.starts[(leaf_key + span0).clamp(0, n_fine)]
    cnt = e - s
    leaf_d2 = morton.point_to_block_dist2(
        qx, qy, leaf_key, a0, index.origin, index.side, l_max
    )
    # `<=`: leaves exactly at the k-th distance are scanned (canonical ties)
    found = run & ~exhausted & (cnt > 0) & (leaf_d2 <= kth2)

    # far/empty aligned-block skip, all candidate levels at once: (Q, L)
    pyr_n = index.pyramid.shape[0]
    ai = levels[None, :]
    blk = torch.bitwise_left_shift(torch.ones_like(ai), 2 * ai)
    cur = cursor[:, None]
    right = dir_r[:, None]
    code = torch.where(right, cur, cur - blk)
    in_dom = torch.where(right, cur + blk <= n_fine, cur - blk >= 0)
    pidx = torch.where(right, cur >> (2 * ai), (cur >> (2 * ai)) - 1)
    lvl_off = (torch.bitwise_left_shift(torch.ones_like(ai), 2 * (l_max - ai))
               - 1) // 3
    empty = index.pyramid[(lvl_off + pidx).clamp(0, pyr_n - 1)] == 0
    far = morton.point_to_block_dist2(
        qx[:, None], qy[:, None], code, ai, index.origin, index.side, l_max
    ) > kth2[:, None]  # strict: blocks AT the k-th distance still get scanned
    aligned = (cur & (blk - 1)) == 0
    ok = aligned & in_dom & (ai >= a0[:, None]) & (empty | far)
    best_a = torch.where(ok, ai, a0[:, None]).amax(dim=1)
    jump = torch.bitwise_left_shift(torch.ones_like(best_a), 2 * best_a)

    step = torch.where(found, span0, jump)
    new_cursor = torch.where(
        run & ~exhausted,
        torch.where(dir_r, cursor + step, cursor - step),
        cursor,
    )
    return found, s, e, new_cursor, run & exhausted


def nav_walk_ref(index, qx, qy, kth2, cl, cr, act_l, act_r, next_right,
                 s_cur, e_cur, max_nav: int):
    """Plain PyTorch version of the kernel, on any device: the bounded
    frontier advance of the rows that navigate this pass.

    Returns ``(cl, cr, act_l, act_r, next_right, s_cur, e_cur, found_any)``.
    """
    levels = torch.arange(1, index.l_max + 1, dtype=torch.int32,
                          device=cl.device)
    found_any = torch.zeros_like(act_l)
    for _ in range(max_nav):
        pending = ~found_any & (act_l | act_r)
        # no row pending: the remaining steps change nothing.  Read on the
        # CPU only, where it costs no device synchronisation.
        if pending.device.type == "cpu" and not pending.any():
            break
        go_right = act_r & (next_right | ~act_l)
        run = pending & (go_right | act_l)
        cursor = torch.where(go_right, cr, cl)
        f, s_f, e_f, cur2, ex = _nav_step(
            index, qx, qy, kth2, cursor, run, go_right, levels
        )
        cr = torch.where(run & go_right, cur2, cr)
        cl = torch.where(run & ~go_right, cur2, cl)
        act_r = act_r & ~(ex & go_right)
        act_l = act_l & ~(ex & ~go_right)
        s_cur = torch.where(f, s_f, s_cur)
        e_cur = torch.where(f, e_f, e_cur)
        # alternate directions while both remain active (paper Sec. 4.2.2)
        next_right = torch.where(f, ~go_right, next_right)
        found_any = found_any | f
    return cl, cr, act_l, act_r, next_right, s_cur, e_cur, found_any


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("nav_walk.cu")
        lib.nav_walk_launch.restype = ctypes.c_int
        lib.nav_walk_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _lib = lib
    return _lib


_ROWS = (("qx", torch.float32), ("qy", torch.float32),
         ("kth2", torch.float32), ("cl", torch.int32), ("cr", torch.int32),
         ("act_l", torch.bool), ("act_r", torch.bool),
         ("next_right", torch.bool), ("s_cur", torch.int32),
         ("e_cur", torch.int32))


def _check(index, rows, max_nav):
    dev = rows[0].device
    n = rows[0].shape[0]
    n_fine = 4**index.l_max
    expect = [(name, t, dtype, (n,)) for (name, dtype), t in zip(_ROWS, rows)]
    # the pyramid's length is read; ``side`` may be () or (1,)
    expect += [("leaf_level", index.leaf_level, torch.int32, (n_fine,)),
               ("starts", index.starts, torch.int32, (n_fine + 1,)),
               ("pyramid", index.pyramid, torch.int32, None),
               ("origin", index.origin, torch.float32, (2,)),
               ("side", index.side, torch.float32, None)]
    for name, t, dtype, shape in expect:
        if t.device != dev:
            raise ValueError(f"nav_walk: {name} is on {t.device}, qx on "
                             f"{dev}")
        if t.dtype != dtype or (shape is not None
                                and tuple(t.shape) != shape):
            raise ValueError(f"nav_walk: {name} must be {dtype} "
                             f"{shape or ''}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nav_walk: {name} must be contiguous")
    if index.side.numel() != 1 or index.pyramid.dim() != 1:
        raise ValueError("nav_walk: side must hold one value and the "
                         "pyramid be flat")
    if max_nav < 0:
        raise ValueError(f"nav_walk: max_nav must be >= 0, got {max_nav}")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def nav_walk(index, qx, qy, kth2, cl, cr, act_l, act_r, next_right, s_cur,
             e_cur, max_nav: int):
    """Up to ``max_nav`` navigation steps of each row against ``index``'s
    tables: ``(cl, cr, act_l, act_r, next_right, s_cur, e_cur, found_any)``,
    each (rows,).

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`nav_walk_ref`.
    """
    rows = (qx, qy, kth2, cl, cr, act_l, act_r, next_right, s_cur, e_cur)
    _check(index, rows, max_nav)
    dev = qx.device
    if dev.type == "cpu":
        return nav_walk_ref(index, *rows, max_nav)
    if dev.type != "cuda":
        raise ValueError(f"nav_walk: unsupported device {dev}")
    n = qx.shape[0]
    # the eight outputs as rows of two buffers: two allocations, not eight
    ints = torch.empty((4, n), dtype=torch.int32, device=dev)
    flags = torch.empty((4, n), dtype=torch.bool, device=dev)
    out = (ints[0], ints[1], flags[0], flags[1], flags[2], ints[2], ints[3],
           flags[3])
    if n == 0:
        return out
    tables = (index.leaf_level, index.starts, index.pyramid, index.origin,
              index.side)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nav_walk_launch(_pointers(rows), _pointers(tables),
                                  _pointers(out), n,
                                  index.l_max, index.pyramid.shape[0],
                                  max_nav, stream)
    if err != 0:
        raise RuntimeError(f"nav_walk: kernel launch failed with cudaError "
                           f"{err}")
    nav_walk.launches += 1
    tracing.count("sweep.nav_launches")
    return out


nav_walk.launches = 0
