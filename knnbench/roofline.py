"""The chip's peaks and the bytes a kernel's work needs at least.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3
at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.  A share of a
peak is stated with the card's power limit beside it.

Imports nothing of the program.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12

POSITION_BYTES = 8  # (x, y) float32
ID_BYTES = 4  # int32
LIST_ENTRY_BYTES = 8  # float32 distance + int32 id


def knn_tick_bytes(n_objects: int, rows: int, k: int) -> int:
    """Bytes one tick's exact k-NN has to move at least, each once.

    Every object's position and id read once (each object is a candidate of
    its own query at least), every query's position and id read once, and
    every row's k-entry list written once.  Whatever a kernel reads again,
    or moves between its launches, is its own cost and not counted, so no
    implementation of the whole tick's selection can beat this count.
    """
    return ((POSITION_BYTES + ID_BYTES) * (n_objects + rows)
            + LIST_ENTRY_BYTES * k * rows)


def roofline_pct(nbytes: float, device_s: float) -> float | None:
    """Least time at the HBM peak over the measured device time, in %."""
    if device_s <= 0:
        return None
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / device_s
