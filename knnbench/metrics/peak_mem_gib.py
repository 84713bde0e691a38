"""peak_mem_gib: torch.cuda.max_memory_allocated() over the run, set-up
included, read when the window closes and before the check runs."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / 2**30
