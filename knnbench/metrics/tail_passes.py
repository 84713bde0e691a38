"""tail_passes: the sweep's passes a tick with fewer live rows than one chunk
(the lockstep's tail), the program's counter ``sweep.tail_passes``, mean per
window tick of a traced run (``knnbench/spans.py``).  A program that does not
count them reports nothing."""
from knnbench import spans

NAME = "sweep.tail_passes"
# the run's loader, and whether its program has counted the counter
_seen = {"port": None, "counted": False}


def counter(port):
    if port is not _seen["port"]:
        _seen.update(port=port, counted=False)
    mod = spans.program(port)
    if mod is None:
        return 0
    counters = mod.totals().counters
    _seen["counted"] = _seen["counted"] or NAME in counters
    return counters.get(NAME, 0)


def read(run):
    return spans.mean(run, "tail_passes") if _seen["counted"] else None
