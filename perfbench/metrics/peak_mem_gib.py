"""The allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), read before the check allocates."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"
LAYER = MOVES = None


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
