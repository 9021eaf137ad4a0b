"""Profiler counting sessions with and without idle margins at their ends.

``chip_smoke.py``'s phase 4c counts the kernels the card ran over one
greedy generate of the random 7B model (captured CUDA graphs) from the
profiler's device records, one session per prefill or per
``PROFILE_CHUNK`` decode steps, and holds the counts to the reckoned
ones.  This probe runs that count ``N`` times each way, alternating: with
``chip_smoke.PROFILE_PAD_S`` seconds idle at each end of a session
(``padded``) and with none (``bare``), and reports how many generates
came up short of the reckoning on each side, with the shortfalls and
whether the tokens stayed equal to an unprofiled generate's.  One
``PROFILE_WINDOW`` line:

    python -m amq_tpu_torch.probes.profile_window [N]

from the root of a checkout (it imports ``chip_smoke``), on the card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 16
    import chip_smoke as cs
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.ops import _cuda
    from amq_tpu_torch.serving.engine import Engine
    if not torch.cuda.is_available():
        raise RuntimeError("the profiler window probe needs a card")
    cs.numerics()
    _cuda.build()
    cfg = get_config("Llama-2-7b-hf")
    model = cs.random_llama7b(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, cs.PROMPT)).astype(np.int32)
    eng = Engine(model, cfg, batch_size=1, max_len=cs.PROMPT + cs.GEN + 8)
    want_toks = eng.generate(prompt, max_new_tokens=cs.GEN)
    L = cfg.num_layers
    want = dict(
        grouped=sum(cs.reckon_grouped(L, cs.GEN - 1, False).values()),
        tile=sum(cs.reckon_tile(L, 1).values()),
        decode_attention=cs.reckon_decode(
            L, 1, cs.PROMPT, cs.GEN - 1, False, False)[
                "decode_attention_indexed"])
    pad = cs.PROFILE_PAD_S
    rec = {side: dict(short=0, shortfalls=[], tokens_equal=True)
           for side in ("padded", "bare")}
    for _ in range(n):
        for side, pad_s in (("padded", pad), ("bare", 0.0)):
            cs.PROFILE_PAD_S = pad_s
            toks, seen = cs.profiled_generate(eng, prompt, cs.GEN)
            short = {k: want[k] - seen[k] for k in want if seen[k] != want[k]}
            r = rec[side]
            r["short"] += bool(short)
            if short:
                r["shortfalls"].append(short)
            r["tokens_equal"] &= bool((toks == want_toks).all())
    cs.PROFILE_PAD_S = pad
    print("PROFILE_WINDOW " + json.dumps(dict(
        generates_each=n, pad_s=pad, want=want, card=cs.smi_line(), **rec)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
