"""qsort_ms: device ms of the program's spans ``plan.sort`` and
``plan.unsort`` (the queries' Morton sort and gathers; the unsort, the
square root and the cost EMA), mean per window tick of a traced run
(``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.span_ms(port, ("plan.sort", "plan.unsort"), "device_ms")


def read(run):
    return spans.mean(run, "qsort_ms")
