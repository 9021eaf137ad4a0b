"""Model FLOPs of the student forwards of the window's architectures
(every sample's tokens through linears, head and causal attention, from
the configuration's shapes) over the window's seconds times the bf16
peak."""

from perfbench import work

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model step", "eval_s"


def read(run):
    tr = run.traffic
    n = sum(len(c["archs"]) for c in run.calls)
    flops = n * run.n_sample * work.prefill_flops(run.shape, tr["seqlen"])
    return 100.0 * flops / (run.window_s * work.BF16_FLOPS) if n else None
