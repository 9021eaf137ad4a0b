"""The grouped GEMV's share of its roofline over the traced slice: the
least time of the decode steps' quantized products (every layer's four
sites at its container width with bf16 scale and zero, the 8-bit head, x
and out at the rows that produced a token, each byte once) over the
device time of the ``grouped_gemv`` kernel group and of ``split_reduce``
(the sums of K-split partials, which the GEMV launches for its splits;
the tile kernel's share of them is counted here too, so the roofline
reads low, never high).  Read only where the decode step's rows (the
engine's slots) are rows that group serves."""

from perfbench import bench, work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "gen_tok_s"
GROUP = "grouped_gemv"


def read(run):
    lo, hi = bench.group_rows(run.cell["root"], GROUP)
    t = bench.group_seconds(run.trace, GROUP, "split_reduce")
    if not t or not lo <= run.n_slots <= hi:
        return None
    rows = [r for it in run.iterations if it["traced"]
            for r in it["decode_rows"]]
    if not rows:
        return None
    return 100.0 * work.products_seconds(run.shape, run.quant, rows) / t
