"""sweep_passes: the program's counter ``sweep.passes`` (passes of the
sweep's host loop that did work, every chunk in lockstep), mean per window
tick of a traced run (``knnbench/spans.py``)."""
from knnbench import spans


def counter(port):
    return spans.counted(port, "sweep.passes")


def read(run):
    return spans.mean(run, "sweep_passes")
