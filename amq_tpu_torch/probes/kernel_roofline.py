"""The fused dequant GEMV alone, per width and container: share of 3.35 TB/s.

    python -m amq_tpu_torch.probes.kernel_roofline

The counterpart of the JAX package's ``scripts/kernel_roofline.py``: for
each (bits, container) pair -- (2,2), (3,3), (3,4), (4,4), (8,8); (3,4)
is 3-bit codes in 4-bit nibbles, what the served model runs -- at the
Llama-2-7B o_proj and down shapes, a chain of 64 ``ops.quant_matmul``
calls whose output, scaled by 1e-3, feeds the next call's input (tiled to
K), so the steps serialize.  The chain is captured in one CUDA graph and
replayed between two events (best of 3, ``chain.graph_ms``).  Where the
script reused one weight, each step here takes the next of enough
distinct weights to overflow the 50 MB L2 (a TPU has no cache there, so
its weights came from device memory every step).  The feedback ops (tile, scale, cast) are
timed alone the same way and taken off: ``us`` is the GEMV's.  It reports
µs, GB/s (packed words + scale/zero, whole arrays, as the script counts
them) and the share of 3.35 TB/s, and checks each case once against
``quant_matmul_reference``.  ``device="cpu"`` runs the checks only,
timing nothing.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..core.device import resolve_device
from ..core.quantize import quantize, to_container
from ..ops import quant_matmul as qm
from .chain import HBM_BYTES_PER_S, graph_ms, rel_err

STEPS = 64
PAIRS = ((2, 2), (3, 3), (3, 4), (4, 4), (8, 8))
#: (label, N, K): the 7B decode sites the script measures
SHAPES = (("o_proj", 4096, 4096), ("down", 4096, 11008))
TOL = 2e-2     # bf16 output, normalized, the JAX suite's decode limit


def bench_site(label, N, K, nbits, container, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)

    def weight():
        W = torch.randn((N, K), generator=gen, device=device)
        return to_container(quantize(W, nbits=nbits, group_size=128,
                                     optimize=False,
                                     meta_dtype=torch.bfloat16), container)

    first = weight()
    nbytes = (first.packed.nbytes + first.scale.nbytes + first.zero.nbytes)
    on_card = device.type == "cuda"
    n_w = min(STEPS, max(2, math.ceil(100e6 / nbytes))) if on_card else 1
    qts = [first] + [weight() for _ in range(n_w - 1)]
    x0 = torch.randn((1, K), generator=gen, device=device).to(torch.bfloat16)
    got = qm.quant_matmul(x0, first)
    rel = rel_err(got, qm.quant_matmul_reference(x0, first,
                                                 out_dtype=torch.float32))
    rec = dict(site=label, N=N, K=K, nbits=nbits, container=container,
               bytes_per_step=nbytes, distinct_weights=n_w, rel_err=rel,
               tol=TOL, ok=rel <= TOL and bool(torch.isfinite(got).all()))
    reps = -(-K // N)

    def feedback(y):
        xn = y.repeat(1, reps)[:, :K] if reps > 1 else y[:, :K]
        return (xn * 1e-3).to(torch.bfloat16)

    if on_card:
        def steps(x):
            for i in range(STEPS):
                x = feedback(qm.quant_matmul(x, qts[i % n_w]))
            return x

        y0 = torch.zeros((1, N), dtype=torch.bfloat16, device=device)

        def feedback_only():
            for _ in range(STEPS):
                feedback(y0)

        step_us = graph_ms(lambda: steps(x0)) * 1e3 / STEPS
        fb_us = graph_ms(feedback_only) * 1e3 / STEPS
        us = step_us - fb_us
        gbs = nbytes / (us * 1e-6) / 1e9
        rec.update(step_us=step_us, feedback_us=fb_us, us=us, gbs=gbs,
                   share_of_peak=gbs * 1e9 / HBM_BYTES_PER_S,
                   out_finite=bool(torch.isfinite(steps(x0)).all()))
        rec["ok"] = rec["ok"] and rec["out_finite"]
    print("ROOFLINE " + json.dumps(rec), flush=True)
    return rec


def main(argv=None, device=None) -> list:
    """Every site x (bits, container) pair; returns the records.  Runs on
    the card unless ``device="cpu"`` is asked for."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    dev = resolve_device(device)
    return [bench_site(label, N, K, nbits, container, dev)
            for label, N, K in SHAPES for nbits, container in PAIRS]


if __name__ == "__main__":
    main()
