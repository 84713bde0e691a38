"""The program's own spans and counters, read by the per-layer metrics of a
traced run.

The program keeps them in its ``tracing`` module, off by default.  A run
whose command line asks for ``--trace 1`` turns it on at the first tick
after the build tick, through :func:`program`, so every warm-up and window
tick records its spans; a ``--trace 0`` run never does, and its end-to-end
metrics stay untraced.  Each reader's ``counter`` returns a running total
over the ticks the program has finished (``tracing.totals()``), and the
harness keeps its change over each tick.  A program without the module (an
older checkout) gives totals of zero, and the readers report nothing.

Imports nothing of the program: the harness hands each counter its loader.
"""
from __future__ import annotations

import sys

_seen = {"port": None, "program": None}


def traced_run(argv=None) -> bool:
    """Does the command line ask for a traced run (``--trace 1``)?"""
    argv = sys.argv[1:] if argv is None else argv
    return any(a == "--trace=1"
               or (a == "--trace" and argv[i + 1:i + 2] == ["1"])
               for i, a in enumerate(argv))


def program(port=None):
    """The program's tracing module, turned on, in a traced run; else None.

    ``port`` is the harness's loader of the program's modules, new in every
    run: the first call of a run with it decides for the run; a call
    without it returns the latest run's answer.
    """
    if port is not None and port is not _seen["port"]:
        mod = None
        if traced_run():
            try:
                mod = port("tracing")
            except ImportError:
                mod = None
            else:
                mod.enable()
        _seen.update(port=port, program=mod)
    return _seen["program"]


def span_ms(port, names, field: str) -> float:
    """The sum of ``field`` (``host_ms`` or ``device_ms``) of the spans
    ``names`` over every tick finished so far; 0 without the program's
    tracing."""
    mod = program(port)
    if mod is None:
        return 0.0
    spans = mod.totals().spans
    return sum(getattr(spans[n], field) or 0.0 for n in names if n in spans)


def counted(port, name: str) -> int:
    """The program's counter ``name`` over every tick finished so far."""
    mod = program(port)
    return 0 if mod is None else mod.totals().counters.get(name, 0)


def mean(run, metric: str):
    """The metric's change per window tick, its mean; None where the
    program's tracing was not on."""
    mod = program()
    if mod is None or not mod.enabled() or not run.ticks:
        return None
    return sum(t["counters"][metric] for t in run.ticks) / len(run.ticks)
