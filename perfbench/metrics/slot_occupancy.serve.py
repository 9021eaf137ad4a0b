"""Mean share of the engine's slots that produced a token, over every
decode step the window's iterations ran (steps after the last slot of a
chunk retired count as empty)."""

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "serving loop", "gen_tok_s"


def read(run):
    chunk = run.traffic["chunk_steps"]
    steps = [it["decode_rows"] + [0] * (chunk - len(it["decode_rows"]))
             for it in run.iterations if it["decode_rows"]]
    rows = [r for s in steps for r in s]
    return 100.0 * sum(rows) / (len(rows) * run.n_slots) if rows else None
