"""ingest_ms: the harness's span around the hand-in calls of a tick
(``ingest_objects`` or ``update_objects``, then ``update_queries``), mean
over the window's ticks."""


def read(run):
    return 1e3 * sum(t["hand_in_s"] for t in run.ticks) / len(run.ticks)
