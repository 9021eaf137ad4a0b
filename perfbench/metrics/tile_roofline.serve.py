"""The multi-row tile kernel's share of its roofline over the traced
slice: for each quantized product of a forward whose padded rows the
``tile`` group serves (prefills at such a bucket, decode steps at such a
slot count), the larger of its FLOPs over the bf16 peak and its bytes
over the bandwidth at the real rows (prompt tokens, slots that produced
a token), summed, over the device time of the ``tile`` group and of
``split_reduce`` (the sums of K-split partials, which the tile kernel
launches for its splits; the GEMV's share of them is counted here too,
so the roofline reads low, never high)."""

from perfbench import bench, work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "gen_tok_s"
GROUP = "tile"


def read(run):
    lo, hi = bench.group_rows(run.cell["root"], GROUP)
    t = bench.group_seconds(run.trace, GROUP, "split_reduce")
    if not t:
        return None
    rows = []
    for it in run.iterations:
        if not it["traced"]:
            continue
        rows += [p for p in it["prefills"]
                 if lo <= min(b for b in run.buckets if p <= b) <= hi]
        if lo <= run.n_slots <= hi:
            rows += it["decode_rows"]
    if not rows:
        return None
    return 100.0 * work.products_seconds(run.shape, run.quant, rows) / t
