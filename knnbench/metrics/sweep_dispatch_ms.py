"""sweep_dispatch_ms: host ms of the program's span ``sweep`` less host ms
of its ``sweep.sync`` spans (the blocking reads of the live rows): the host
issuing the sweep's work, mean per window tick of a traced run
(``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return (spans.span_ms(port, ("sweep",), "host_ms")
            - spans.span_ms(port, ("sweep.sync",), "host_ms"))


def read(run):
    return spans.mean(run, "sweep_dispatch_ms")
