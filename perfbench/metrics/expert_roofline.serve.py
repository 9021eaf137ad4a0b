"""The routed-expert products' share of their roofline over the traced
slice: the least time of the decode steps' expert products (each expert
the router chose, per layer and step, its words at the layer's container
width and its bf16 scale and zero read once; per pair x read and the
output written once: ``perfbench.work.moe.expert_products_seconds``) over
the device time of the ``moe_gemv`` kernel group (the decode form of the
expert products; it launches no K-split sums).  The experts chosen are
the router's output as the port's device counters report it for the
decode form over the slice (the loop's slice summary, ``"moe"``), not a
launch count.  Read only where the decode step's rows (the engine's
slots) are rows that group serves."""

from perfbench import bench
from perfbench.work import moe as work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "gen_tok_s"
GROUP = "moe_gemv"


def read(run):
    lo, hi = bench.group_rows(run.cell["root"], GROUP)
    t = bench.group_seconds(run.trace, GROUP)
    counts = (run.trace or {}).get("moe", {}).get("gemv")
    if not t or not counts or not counts["experts_hit"] \
            or not lo <= run.n_slots <= hi:
        return None
    least = work.expert_products_seconds(
        run.shape, run.quant, counts["experts_hit_by_layer"], counts["pairs"])
    return 100.0 * least / t
