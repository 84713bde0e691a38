"""collect_ms: ``TickResult.collect_s``, the program's own span of the
device-to-host copy of the lists alone, mean over the window's ticks."""


def read(run):
    return 1e3 * sum(t["collect_s"] for t in run.ticks) / len(run.ticks)
