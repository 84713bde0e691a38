"""scan_device_ms: device ms of the program's span ``sweep.scan`` (each
pass's window gathers and B1's merge, from the stream reaching its first
operation to the end of its last), summed over the tick's passes, mean per
window tick of a traced run (``knnbench/spans.py``).  A program that times
the span on the host alone reports nothing."""
from knnbench import spans

NAME = "sweep.scan"
# the run's loader, and whether its program timed the span on the device
_seen = {"port": None, "timed": False}


def counter(port):
    if port is not _seen["port"]:
        _seen.update(port=port, timed=False)
    mod = spans.program(port)
    if mod is None:
        return 0.0
    st = mod.totals().spans.get(NAME)
    if st is None or st.device_ms is None:
        return 0.0
    _seen["timed"] = True
    return st.device_ms


def read(run):
    return spans.mean(run, "scan_device_ms") if _seen["timed"] else None
