"""Set-up: process start to the first timed step (loading the cached
libraries, weights made on the device, graph captures, the ramp)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER = MOVES = None


def read(run):
    return run.setup_s
