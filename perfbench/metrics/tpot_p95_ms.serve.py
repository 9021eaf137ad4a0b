"""Time per output token: per request completed in the window, (last
token's arrival - first token's) / (tokens - 1); the 95th percentile."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "serving loop", "gen_tok_s"


def read(run):
    if not run.tpot_s:
        return None
    return float(np.percentile(np.asarray(run.tpot_s), 95)) * 1e3
