"""Share of the traced slice in which no kernel, copy or set ran on the
device (``torch.profiler``; the union of device intervals)."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "eval_s"


def read(run):
    if not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
