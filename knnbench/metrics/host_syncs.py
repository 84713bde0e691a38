"""host_syncs: the program's counter ``host.syncs`` (reads the host makes
that block on the device: the sweep's two a pass and its last, the
finalize's scalars, the drain, each copy of the result), mean per window
tick of a traced run (``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.counted(port, "host.syncs")


def read(run):
    return spans.mean(run, "host_syncs")
