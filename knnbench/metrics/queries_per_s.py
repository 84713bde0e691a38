"""queries_per_s: k-NN answers returned per second of the window, every row
of every completed tick over the seconds from the window's start to the end
of its last tick."""


def read(run):
    return sum(t["rows"] for t in run.ticks) / run.window_s
