"""refresh_ms: device ms of the program's span ``refresh`` (the tick's index
re-sort or delta splice, from the stream reaching its first operation to
the end of its last), mean per window tick of a traced run
(``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.span_ms(port, ("refresh",), "device_ms")


def read(run):
    return spans.mean(run, "refresh_ms")
