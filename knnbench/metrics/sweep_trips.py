"""sweep_trips: ``TickResult.iterations`` (the sum over the tick's chunks of
their lockstep trips), mean over the window's ticks."""


def read(run):
    return sum(t["iterations"] for t in run.ticks) / len(run.ticks)
