"""sweep_ms: device ms of the program's span ``sweep`` (the sorted batch's
sweep, set-up to return), mean per window tick of a traced run
(``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.span_ms(port, ("sweep",), "device_ms")


def read(run):
    return spans.mean(run, "sweep_ms")
