"""cand_per_row_pass: the candidate slots B1 fills of the window it is handed
a row: ``TickResult.candidates`` over the program's counter ``sweep.rows``
(the live rows of every pass, summed), over the window ticks of a traced run
(``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.counted(port, "sweep.rows")


def read(run):
    if spans.mean(run, "cand_per_row_pass") is None:
        return None
    rows = sum(t["counters"]["cand_per_row_pass"] for t in run.ticks)
    return sum(t["candidates"] for t in run.ticks) / rows if rows else None
