"""Masked squared-L2 distance tile: (Q,) queries x (C,) candidates -> (Q, C).

Replaces the Pallas TPU kernel ``repro/kernels/pairwise_dist.py::
pairwise_dist`` (``pl.pallas_call`` at ``pairwise_dist.py:53``) with the
hand-written Hopper kernel ``csrc/pairwise_dist.cu`` (a thread computes four
neighbouring columns of eight query rows; see the source's header).  Bound on
an H100: memory, the (Q, C) f32 write: at Q = 2048, C = 1,000,064 that is
8.19 GB, about 2.45 ms at 3.35 TB/s.

:func:`pairwise_dist` launches the kernel for CUDA tensors (or raises) and
runs :func:`pairwise_dist_ref`, the plain PyTorch version, for CPU tensors.
``pairwise_dist.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..runtime import fma

__all__ = ["pairwise_dist", "pairwise_dist_ref", "Q_TILE", "C_TILE"]

Q_TILE = 8
C_TILE = 128


def pairwise_dist_ref(qx, qy, px, py, valid):
    """Plain version: ``fma(dx, dx, dy*dy)`` with ``dx = qx - px``, +inf
    where the candidate is invalid, as the reference's compiled kernel."""
    dx = qx[:, None] - px[None, :]
    dy = qy[:, None] - py[None, :]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=qx.device)
    return torch.where(valid[None, :], fma(dx, dx, dy * dy), inf)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("pairwise_dist.cu")
        lib.pairwise_dist_f32.restype = ctypes.c_int
        lib.pairwise_dist_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def check_planes(fn: str, qx, qy, px, py, valid):
    """(Q,) f32 query planes and (C,) f32 / bool candidate planes, each
    contiguous, on one CPU or CUDA device; returns ``(Q, C, device)``."""
    q, c = qx.shape[0], px.shape[0]
    dev = qx.device
    for name, t, dtype, n in (("qx", qx, torch.float32, q),
                              ("qy", qy, torch.float32, q),
                              ("px", px, torch.float32, c),
                              ("py", py, torch.float32, c),
                              ("valid", valid, torch.bool, c)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, qx on {dev}")
        if t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(f"{fn}: {name} must be {dtype} ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return q, c, dev


def pairwise_dist(qx, qy, px, py, valid):
    """(Q,),(Q,),(C,),(C,),(C,) bool -> (Q, C) f32 masked squared distances.

    Q must be a multiple of ``Q_TILE`` and C of ``C_TILE``.
    """
    q, c, dev = check_planes("pairwise_dist", qx, qy, px, py, valid)
    if q % Q_TILE or c % C_TILE:
        raise ValueError(f"pairwise_dist: Q={q} and C={c} must be multiples "
                         f"of {Q_TILE} and {C_TILE} (pairwise_dist_op pads)")
    if dev.type == "cpu":
        return pairwise_dist_ref(qx, qy, px, py, valid)
    out = torch.empty((q, c), dtype=torch.float32, device=dev)
    if q == 0 or c == 0:
        return out
    # the kernel loads px / py as float4 and valid as 4 bytes
    px, py, valid = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (px, py, valid))
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_dist_f32(qx.data_ptr(), qy.data_ptr(),
                                    px.data_ptr(), py.data_ptr(),
                                    valid.data_ptr(), out.data_ptr(), q, c,
                                    stream)
    if err != 0:
        raise RuntimeError(f"pairwise_dist: kernel launch failed with "
                           f"cudaError {err}")
    pairwise_dist.launches += 1
    return out


pairwise_dist.launches = 0
