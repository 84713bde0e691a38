"""submit_ms: the harness's span around ``KnnSession.submit()``, mean over
the window's ticks."""


def read(run):
    return 1e3 * sum(t["submit_s"] for t in run.ticks) / len(run.ticks)
