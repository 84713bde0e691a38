"""setup_s: the process's start to the window's start: imports, kernel
loading (and building, on a checkout's first run), the traffic, the ingest,
the build tick and the warm-up ticks."""


def read(run):
    return run.setup_s
