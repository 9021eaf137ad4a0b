"""Tokens that reached the host inside the window, over the window's
seconds (every first token and every decoded token, all requests)."""

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"
LAYER = MOVES = None


def read(run):
    tokens = sum(it["tokens"] for it in run.iterations)
    return tokens / run.window_s if tokens else None
