"""Morton (Z-order) coding for 2-D points, in PyTorch.

Counterpart of ``repro/core/morton.py``.  Where the reference works in uint32
(``part1by1``, ``compact1by1``) this module works in int64 masked to the low
32 bits, which gives the same codes.  Codes and cell coordinates leave every
public function as int32.
"""
from __future__ import annotations

import torch

from ..runtime import fma

__all__ = [
    "part1by1",
    "compact1by1",
    "encode_cells",
    "decode_code",
    "points_to_cells",
    "morton_encode_points",
    "block_box",
    "point_to_block_dist2",
]

_U32 = 0xFFFFFFFF


def part1by1(v: torch.Tensor) -> torch.Tensor:
    """Insert a zero bit between each of the low 16 bits of ``v`` (-> int64)."""
    v = v.to(torch.int64) & _U32
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def compact1by1(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`part1by1`: extract even-position bits (-> int64)."""
    v = v.to(torch.int64) & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def encode_cells(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Morton-interleave integer cell coordinates -> int32 code."""
    return (part1by1(cx) | (part1by1(cy) << 1)).to(torch.int32)


def decode_code(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Morton code -> (cx, cy) integer cell coordinates (int32)."""
    z = z.to(torch.int64) & _U32
    return compact1by1(z).to(torch.int32), compact1by1(z >> 1).to(torch.int32)


def points_to_cells(points, origin, side, level: int):
    """Map (N, 2) points to integer cell coords of the 2^level x 2^level grid.

    ``origin`` and ``side`` are f32 tensors on the points' device, so the
    division is a true IEEE division (a Python scalar divisor may become a
    reciprocal multiply on the card).  The reference's saturating convert
    (NaN -> 0) is reproduced by clamping in float before the int32 cast.
    """
    n_cells = 1 << level
    rel = (points - origin[None, :]) / side
    c = torch.floor(rel * n_cells)
    c = torch.nan_to_num(c, nan=0.0).clamp(0, n_cells - 1).to(torch.int32)
    return c[:, 0], c[:, 1]


def morton_encode_points(points, origin, side, level: int) -> torch.Tensor:
    """(N, 2) float points -> (N,) int32 Morton codes at ``level``."""
    cx, cy = points_to_cells(points, origin, side, level)
    return encode_cells(cx, cy)


def block_box(code, a, origin, side, l_max: int):
    """Geometry (x0, y0, x1, y1) of the aligned block ``[code, code + 4**a)``.

    ``origin + cx * cellw`` is one fused multiply-add, as in the reference's
    compiled program; ``span * cellw`` is exact (a power of two times cellw).
    """
    cellw = side / (1 << l_max)
    cx, cy = decode_code(code)
    span = torch.bitwise_left_shift(torch.ones_like(cx), a).to(torch.float32)
    x0 = fma(cx.to(torch.float32), cellw, origin[0])
    y0 = fma(cy.to(torch.float32), cellw, origin[1])
    x1 = x0 + span * cellw
    y1 = y0 + span * cellw
    return x0, y0, x1, y1


def point_to_block_dist2(px, py, code, a, origin, side, l_max: int):
    """Squared min distance from point(s) to the aligned block ``[code, code+4**a)``.

    The reference's compiled form is ``fma(dy, dy, dx * dx)``.
    """
    x0, y0, x1, y1 = block_box(code, a, origin, side, l_max)
    zero = torch.zeros((), dtype=torch.float32, device=x0.device)
    dx = torch.maximum(torch.maximum(x0 - px, px - x1), zero)
    dy = torch.maximum(torch.maximum(y0 - py, py - y1), zero)
    return fma(dy, dy, dx * dx)
