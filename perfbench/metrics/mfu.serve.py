"""Model FLOPs of the window's real prompt tokens and generated tokens
(linears, head and causal attention, from the configuration's shapes)
over the window's seconds times the bf16 peak."""

from perfbench import work

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model step", "gen_tok_s"


def read(run):
    flops = 0.0
    for it in run.iterations:
        flops += sum(work.prefill_flops(run.shape, p) for p in it["prefills"])
        flops += work.decode_flops(run.shape, sum(it["decode_rows"]),
                                   it["decode_keys"])
    return 100.0 * flops / (run.window_s * work.BF16_FLOPS) if flops else None
