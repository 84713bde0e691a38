"""live_row_pct: the sweep's lockstep occupancy, in %: the program's counter
``sweep.rows`` (the live rows of every pass, summed) over ``sweep.passes``
times the tick's rows, over the window ticks of a traced run
(``knnbench/spans.py``).  The last chunk's padding rows count among the live
rows (under 0.8% of a 1M tick's)."""
import numpy as np

from knnbench import spans


def counter(port):
    return np.array([spans.counted(port, "sweep.rows"),
                     spans.counted(port, "sweep.passes")], dtype=np.int64)


def read(run):
    if spans.mean(run, "live_row_pct") is None:
        return None
    live = sum(int(t["counters"]["live_row_pct"][0]) for t in run.ticks)
    slots = sum(int(t["counters"]["live_row_pct"][1]) * t["rows"]
                for t in run.ticks)
    return 100.0 * live / slots if slots else None
