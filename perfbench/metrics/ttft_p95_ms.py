"""95th percentile of the time to first token over every request whose
first token reached the host inside the window, from the client's send."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = MOVES = None


def read(run):
    if not run.ttft_s:
        return None
    return float(np.percentile(np.asarray(run.ttft_s), 95)) * 1e3
