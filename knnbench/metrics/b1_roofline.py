"""b1_roofline: B1's share of its roofline, in %, over the traced ticks.

The least time is the bytes the ticks' exact k-NN needs at least, each once
(``roofline.knn_tick_bytes``: objects and queries read once, lists written
once), at the HBM peak; the time is the device time of B1's kernels, found
by name in the trace.  State it with the card's power limit.
"""
from knnbench import roofline

# the kernels of kernels/csrc/fused_scan.cu (narrow queue, rounds, wide)
KERNELS = ("fused_scan_",)


def read(run):
    if run.trace is None:
        return None
    nbytes = sum(roofline.knn_tick_bytes(run.n_objects, t["rows"], run.k)
                 for t in run.traced)
    return roofline.roofline_pct(nbytes, run.trace.device_seconds(KERNELS))
