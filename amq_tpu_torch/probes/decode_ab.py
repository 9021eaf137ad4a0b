"""Decode and prefill A/B across checkouts: the 7B decode loop's wall and
device time, the host cost of one decode-GEMV call, and the 64-token
prefill's time, device time and bf16 logit gap, per tree.

Each ROOT is a checkout of the repo (this one, or an earlier commit
unpacked beside it); each runs in a process of its own, in the order
given (e.g. parent, change, change, parent, so drift shows), on that
tree's own package and ``chip_smoke.py`` helpers: the random 7B model of
``chip_smoke.py``'s phase 4 (layers at 2, 3 and 4 bits in turn), then

* ``decode_wall_ms``: wall ms per decode token of one stream, unprofiled,
  the median of :data:`REPEATS` runs of :data:`STEPS` steps, each from
  the prompt's cache length (the tree's engine, captured CUDA graphs
  where it has them);
* ``profile_*``: ``chip_smoke.profile_decode`` (device and wall ms per
  token under the profiler) and ``continuous_profile``'s default (per
  4-slot step);
* ``host_us``: host microseconds per eager ``quant_matmul_indexed`` call
  at the 7B gateup site (4-bit, M = 1, bf16 x and meta), whichever route
  the tree's wrapper takes; ``route`` says which; ``host_us_cuda_core``
  the same call forced onto the CUDA-core route, where the tree has that
  private route;
* the 64-token prefill: ``prefill_ms`` and ``ttft_ms`` (the medians of
  :data:`REPEATS` runs of ``benchmark_speed``'s GEMM and TTFT modes),
  ``prefill_device_ms`` and ``prefill_busy_share`` (one prefill under the
  profiler, ``chip_smoke.device_profile``) and ``logit_gap``
  (``chip_smoke.logits_check`` in bf16: the kernel path's last-position
  prefill logits against the plain path's, normalized).

With ``--dtype float32`` the engine computes in float32 (compute and
cache dtype; the float32 forms of the decode GEMVs and prefill products
on trees that have them), the gateup call takes f32 x, the logit gap is
``logits_check``'s float32 one (``logit_gap``) and the continuous
(bf16 slot) profile is skipped.

One ``AB`` line per root:

    python -m amq_tpu_torch.probes.decode_ab [--dtype float32] ROOT [ROOT ...]

on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

STEPS, REPEATS = 16, 5

_CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
import chip_smoke as cs
from amq_tpu_torch.models.config import get_config
from amq_tpu_torch.ops import quant_matmul as qm
from amq_tpu_torch.serving.benchmark import benchmark_speed
from amq_tpu_torch.serving.engine import Engine

steps, repeats = int(sys.argv[1]), int(sys.argv[2])
dtype = getattr(torch, sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config("Llama-2-7b-hf")
gen = torch.Generator(device="cuda").manual_seed(0)
model = cs.random_llama7b(cfg, gen)
eng = Engine(model, cfg, batch_size=1, max_len=cs.PROMPT + cs.GEN + 8,
             compute_dtype=dtype, cache_dtype=dtype)
prompt = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (1, cs.PROMPT)).astype(np.int32)
eng.generate(prompt, max_new_tokens=4)
cache = eng.new_cache()
first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt), cache)
# a tree whose decode advances the cache length in place decodes every
# timed run from the prompt's length (elsewhere the copy changes nothing)
start = cache.length.clone()
eng._decode_n(model, first, cache, n_steps=2)
walls = []
for _ in range(repeats):
    cache.length.copy_(start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_n(model, first, cache, n_steps=steps)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3 / steps)
prof = cs.profile_decode(eng, prompt)
cont = (cs.continuous_profile(model, cfg)["default"]
        if dtype == torch.bfloat16 else {})
prefill = {mode: statistics.median(
    benchmark_speed(eng, mode, prompt_len=cs.PROMPT, gen_len=cs.GEN)[key]
    for _ in range(repeats))
    for mode, key in (("GEMM", "prefill_ms"), ("TTFT", "ttft_ms"))}
toks = eng.tokens_to_device(prompt)
pre_prof = cs.device_profile(
    lambda: eng._prefill_token(model, toks, eng.new_cache()), 1)
gap = cs.logits_check(model, cfg, prompt, dtype)["rel_err"]
del model, eng, cache
torch.cuda.empty_cache()

N, K, _ = cs.SITES_7B["gateup"]
packed, scale, zero, sb = cs.rand_site(N, K, 4, 2, torch.bfloat16, gen)
x = torch.randn((1, K), generator=gen, device="cuda").to(dtype)
kw = dict(nbits=4, group_size=128, shape=(N, K), superblock=sb)
before = getattr(qm.quant_matmul_indexed, "grouped_launches", 0)
qm.quant_matmul_indexed(x, packed, scale, zero, 1, **kw)
grouped = getattr(qm.quant_matmul_indexed, "grouped_launches", 0) > before
host = cs.host_us(lambda: qm.quant_matmul_indexed(x, packed, scale, zero, 1,
                                                  **kw))
core = getattr(qm, "_qmm_cuda_core", None)      # the forced CUDA-core route
host_core = (cs.host_us(lambda: core(x, packed[1], scale[1], zero[1],
                                     out_dtype=dtype, **kw))
             if core else None)
print("AB " + json.dumps(dict(
    dtype=sys.argv[3],
    decode_wall_ms=statistics.median(walls), decode_wall_runs_ms=walls,
    profile_device_ms=prof["device_ms_per_token"],
    profile_wall_ms=prof["wall_ms_per_token"],
    continuous_device_ms=cont.get("device_ms_per_token"),
    continuous_wall_ms=cont.get("wall_ms_per_token"),
    host_us=host, route="grouped" if grouped else "cuda-core",
    host_us_cuda_core=host_core, prefill_ms=prefill["GEMM"],
    ttft_ms=prefill["TTFT"], prefill_device_ms=pre_prof["device_ms_per_token"],
    prefill_busy_share=pre_prof["device_busy_share"],
    prefill_top_kernels_ms=pre_prof["top_kernels_ms_per_token"],
    logit_gap=gap)), flush=True)
"""


def run(root: str, steps: int = STEPS, repeats: int = REPEATS,
        dtype: str = "bfloat16") -> dict:
    """One root's record (``root`` and its ``AB`` numbers) with the engine
    in ``dtype`` (bfloat16 or float32)."""
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(steps),
                           str(repeats), dtype], cwd=root, env=env,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode or not lines:
        raise SystemExit(f"decode_ab: {root} failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    return dict(root=root, **json.loads(lines[-1][3:]))


def main(argv=None) -> list:
    roots = list(argv if argv is not None else sys.argv[1:])
    dtype = "bfloat16"
    if roots[:1] == ["--dtype"]:
        dtype, roots = (roots[1:2] or [""])[0], roots[2:]
    if not roots or dtype not in ("bfloat16", "float32"):
        raise SystemExit("usage: python -m amq_tpu_torch.probes.decode_ab "
                         "[--dtype float32] ROOT [ROOT ...]")
    recs = []
    for root in roots:
        rec = run(root, dtype=dtype)
        print("AB " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
