"""device_idle_pct: the share of a tick in which no operation runs on the
device, in %: 1 - (device-busy seconds per traced tick, the union of the
device's intervals in a trace of the device alone) / (wall seconds per tick
of the untraced window).  The wall comes from the window, so the profiler's
own cost on the host, which slows a traced tick, stays out of the share."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.traced:
        return None
    busy = run.trace.busy_s / len(run.traced)
    wall = run.window_s / len(run.ticks)
    return 100.0 * (1.0 - busy / wall)
