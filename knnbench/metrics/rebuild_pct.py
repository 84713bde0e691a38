"""rebuild_pct: the share of the window's ticks whose result says
``rebuilt`` (a drift rebuild of the partition), in %."""


def read(run):
    return 100.0 * sum(t["rebuilt"] for t in run.ticks) / len(run.ticks)
