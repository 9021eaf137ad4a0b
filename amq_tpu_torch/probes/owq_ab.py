"""OWQ decode A/B across checkouts, and the grouped ring's outputs at
whole-stage layouts compared bit for bit.

Each ROOT is a checkout of the repo (this one, or an earlier commit
unpacked beside it, e.g. ``git archive`` into the ignored
``_archive/parent``); each runs in a process of its own, in the order
given, on that tree's package with this checkout's ``chip_smoke.py`` (so
that a tree from before its phase 7c can be measured):

* by default ``chip_smoke.owq_decode_phase``: an ``OWQ_DECODE`` line per
  root (Llama-2-7B in OWQ's packed form at 32 layers, bf16 on graphs,
  prompt 64 -> 128; gated on this checkout only), e.g. parent, change,
  change, parent, so that drift shows;
* with ``--equal`` the outputs of the grouped-ring kernels at the
  whole-stage layouts (rows 1 and 7 at qkv / o / gateup, rows 2 and 8 at
  down, at the stacked 7B and tp-2 shard shapes, widths 2 / 3 / 4, M 1 /
  4 / 8; row 4 at the 8-bit heads, M 1 / 5 / 8; row 6 at 2 / 3 / 4 bits;
  seeded inputs), then an ``EQUAL`` line per root: which of its outputs
  are ``torch.equal`` to the first root's.

    python -m amq_tpu_torch.probes.owq_ab [--equal] ROOT [ROOT ...]

on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

#: the repo's chip_smoke.py (this checkout's)
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chip_smoke.py")

_CHILD = r"""
import importlib.util, os, sys
root, smoke, mode, out, gate = sys.argv[1:6]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
import torch
from amq_tpu_torch.ops import _cuda
from amq_tpu_torch.ops import quant_matmul as qm
assert _cuda.__file__.startswith(root), _cuda.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_cuda.build()
print("ROOT", root, flush=True)
if mode == "owq":
    cs.owq_decode_phase(gate=gate == "1")
    sys.exit(0)
outs, seed = {}, [0]

def gen():
    seed[0] += 1
    return torch.Generator(device="cuda").manual_seed(seed[0])

def bf16(shape, g):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

for site in ("qkv", "o", "gateup", "down", "qkv_tp2", "o_tp2", "gateup_tp2",
             "down_tp2"):
    N, K, _ = cs.SITES_7B[site]
    for nbits in (2, 3, 4):
        g = gen()
        packed, scale, zero, sb = cs.rand_site(N, K, nbits, 2,
                                               torch.bfloat16, g)
        kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
                  out_dtype=torch.bfloat16)
        for M in (1, 4, 8):
            x, u = bf16((M, K), g), bf16((M, K), g)
            w = (packed, scale, zero, 1)
            if site.startswith("down"):
                outs[f"{site}/{nbits}/{M}/row2"] = \
                    qm.quant_matmul_swiglu_indexed(x, u, *w, **kw)
                outs[f"{site}/{nbits}/{M}/row8"] = \
                    qm.quant_matmul_swiglu_indexed_pipe(x, u, *w, **kw)
            else:
                outs[f"{site}/{nbits}/{M}/row1"] = \
                    qm.quant_matmul_indexed(x, *w, **kw)
                outs[f"{site}/{nbits}/{M}/row7"] = \
                    qm.quant_matmul_indexed_pipe(x, *w, **kw)
for site in ("head", "head_tp2"):
    N, K, _ = cs.SITES_7B[site]
    g = gen()
    packed, scale, zero, sb = cs.rand_site(N, K, 8, 1, torch.bfloat16, g)
    qt = qm.QuantizedTensor(packed[0], scale[0], zero[0], 8, 128, (N, K), sb)
    for M in (1, 5, 8):
        outs[f"{site}/8/{M}/row4"] = qm.quant_matmul(
            bf16((M, K), g), qt, out_dtype=torch.float32)
(Ngu, H), (Nd, I) = cs.MLP_7B
for nbits in (2, 3, 4):
    g = gen()
    gu = cs.rand_site(Ngu, H, nbits, 2, torch.bfloat16, g)
    dn = cs.rand_site(Nd, I, nbits, 2, torch.bfloat16, g)
    kw = dict(nbits=nbits, group_size=128, gu_shape=(Ngu, H),
              d_shape=(Nd, I), superblock=gu[3])
    for M in (1, 4, 8):
        outs[f"mlp/{nbits}/{M}/row6"] = qm.quant_matmul_mlp_indexed(
            bf16((M, H), g), *gu[:3], *dn[:3], 1, out_dtype=torch.bfloat16,
            **kw)
torch.save({k: v.cpu() for k, v in outs.items()}, out)
"""


def run(root: str, mode: str, out: str = "", gate: bool = False) -> None:
    """One root's child process (``mode`` "owq" or "equal"); raises if it
    fails."""
    subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root),
                    SMOKE, mode, out, "1" if gate else "0"], check=True)


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    equal = "--equal" in argv
    roots = [a for a in argv if a != "--equal"]
    if not roots:
        raise SystemExit("usage: python -m amq_tpu_torch.probes.owq_ab "
                         "[--equal] ROOT [ROOT ...]")
    here = os.path.dirname(SMOKE)
    if not equal:
        for root in roots:
            run(root, "owq", gate=os.path.samefile(root, here))
        return []
    import torch
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate(roots):
            path = os.path.join(tmp, f"{i}.pt")
            run(root, "equal", path)
            outs.append(torch.load(path))
        for root, got in zip(roots, outs):
            differ = sorted(k for k in outs[0]
                            if not torch.equal(got[k], outs[0][k]))
            recs.append(dict(root=os.path.abspath(root), against=roots[0],
                             cases=len(got), equal=len(got) - len(differ),
                             differ=differ))
            print("EQUAL " + json.dumps(recs[-1]), flush=True)
    return recs


if __name__ == "__main__":
    if any(r["differ"] for r in main()):
        raise SystemExit("owq_ab: outputs differ between checkouts")
