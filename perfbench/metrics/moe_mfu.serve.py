"""Model FLOPs of the window's real prompt tokens and generated tokens
over the window's seconds times the bf16 peak, for a sparse (Qwen2-MoE)
model: each token's active parameters (attention, the shared expert, the
top-k routed experts, router and shared gate, head) and causal attention,
from the configuration's shapes (``perfbench.work.moe``)."""

from perfbench.work import moe as work
from perfbench.work import BF16_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model step", "gen_tok_s"


def read(run):
    if "num_experts" not in run.shape:
        return None
    flops = 0.0
    for it in run.iterations:
        flops += sum(work.prefill_flops(run.shape, p) for p in it["prefills"])
        flops += work.decode_flops(run.shape, sum(it["decode_rows"]),
                                   it["decode_keys"])
    return 100.0 * flops / (run.window_s * BF16_FLOPS) if flops else None
