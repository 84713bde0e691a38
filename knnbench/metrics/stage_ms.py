"""stage_ms: host ms of the program's span ``submit.stage`` (the query
batch's pad and uploads, and the cost and weight staging), mean per window
tick of a traced run (``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.span_ms(port, ("submit.stage",), "host_ms")


def read(run):
    return spans.mean(run, "stage_ms")
