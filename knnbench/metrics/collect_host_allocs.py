"""collect_host_allocs: the pinned host blocks that the copy of a tick's
result to the host had to create (the change in the caching host allocator's
``num_host_alloc`` across its allocations), the program's counter
``collect.host_allocs``, mean per window tick of a traced run
(``knnbench/spans.py``).  0 once the blocks of earlier results are reused.
A program that copies into pageable memory (it counts no
``collect.pinned``) reports nothing."""
from knnbench import spans

NAME = "collect.host_allocs"
# the run's loader, and whether its program has pinned a copy
_seen = {"port": None, "pinned": False}


def counter(port):
    if port is not _seen["port"]:
        _seen.update(port=port, pinned=False)
    mod = spans.program(port)
    if mod is None:
        return 0
    counters = mod.totals().counters
    _seen["pinned"] = _seen["pinned"] or "collect.pinned" in counters
    return counters.get(NAME, 0)


def read(run):
    return spans.mean(run, "collect_host_allocs") if _seen["pinned"] else None
