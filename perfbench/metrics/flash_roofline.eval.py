"""Flash attention's share of its roofline over the traced slice: the
causal attention FLOPs of the student forwards of the architectures
evaluated in the slice (every layer, every sample) over the bf16 peak,
over the device time of the ``flash`` kernel group."""

from perfbench import work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "eval_s"


def read(run):
    t = (run.trace or {}).get("group_s", {}).get("flash")
    n = sum(len(c["archs"]) for c in run.calls if c["traced"])
    if not t or not n:
        return None
    tr = run.traffic
    flops = n * run.n_sample * work.attention_flops(run.shape, tr["seqlen"], 0)
    return 100.0 * flops / work.BF16_FLOPS / t
