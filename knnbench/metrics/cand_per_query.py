"""cand_per_query: ``TickResult.candidates`` (candidate slots scanned) over
the tick's rows, over the whole window."""


def read(run):
    return (sum(t["candidates"] for t in run.ticks)
            / sum(t["rows"] for t in run.ticks))
