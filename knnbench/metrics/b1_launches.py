"""b1_launches: launches of B1, the fused SCAN merge kernel, per tick: the
change over each window tick of the wrapper's own launch counters (fp32 and
mixed)."""


def counter(port):
    f = port("kernels.fused_scan").fused_scan_merge
    return f.launches + f.mixed_launches


def read(run):
    return sum(t["counters"]["b1_launches"] for t in run.ticks) / len(run.ticks)
