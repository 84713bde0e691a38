"""nav_launches: launches of the sweep's navigation kernel per tick, the
program's counter ``sweep.nav_launches`` (one a sweep pass that has a
navigating row), mean per window tick of a traced run
(``knnbench/spans.py``).  A program without the kernel's wrapper
(``kernels.nav_walk``) reports nothing."""
from knnbench import spans

# the run's loader, and whether its program has the kernel
_seen = {"port": None, "kernel": False}


def counter(port):
    if port is not _seen["port"]:
        try:
            port("kernels.nav_walk")
        except ImportError:
            _seen.update(port=port, kernel=False)
        else:
            _seen.update(port=port, kernel=True)
    return spans.counted(port, "sweep.nav_launches") if _seen["kernel"] else 0


def read(run):
    return spans.mean(run, "nav_launches") if _seen["kernel"] else None
