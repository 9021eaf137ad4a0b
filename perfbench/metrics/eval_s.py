"""Seconds per evaluated architecture: the window (which ends with the
last whole ``eval_many`` call) over the architectures it evaluated."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER = MOVES = None


def read(run):
    n = sum(len(c["archs"]) for c in run.calls)
    return run.window_s / n if n else None
