"""Float32 flash attention A/B across checkouts.

Each ROOT is a checkout of the repo (this one, or an earlier commit
unpacked beside it, e.g. ``git archive`` into the ignored
``_archive/parent``); each runs in a process of its own, in the order
given, on that tree's package with this checkout's ``chip_smoke.py`` (so
that a tree from before a case was added is measured at the same
shapes).  Per root:

* ``FLASH_REGS`` / ``FLASH_SASS``: registers and spill bytes of that
  tree's flash kernels (``-Xptxas -v``) and their HGMMA / HMMA / FFMA /
  LDS counts with the tensor-core products of TF32 type (``TF32_MMA``),
  from ``cuobjdump -sass``;
* a ``CASE`` line per float32 case of ``chip_smoke.FLASH_CASES``
  (``chip_smoke.check_flash``: error against the plain version, two calls
  ``torch.equal``, kernel / plain / SDPA ms, both bounds);
* with ``--realize``, ``REALIZE_AB`` lines: the quantize CLI's GPTQ and
  AWQ realizations at full Llama-2-7B width and depth (chip_smoke's
  phase 7b settings, on one cycled 2/3/4-bit arch), their seconds per
  stage and flash launches.

    python -m amq_tpu_torch.probes.flash_ab [--realize] ROOT [ROOT ...]

on the card, e.g. ``--realize _archive/parent .`` and then
``. _archive/parent``, so that the kernel times run parent, change,
change, parent.
"""

from __future__ import annotations

import os
import subprocess
import sys

#: the repo's chip_smoke.py (this checkout's)
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chip_smoke.py")

_CHILD = r"""
import importlib.util, json, os, re, sys, tempfile, time
root, smoke, realize = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
import torch
from amq_tpu_torch import ops
from amq_tpu_torch.ops import _cuda
from amq_tpu_torch.ops import flash_attention as fa
from amq_tpu_torch.probes import kernel_attrib as ka
assert _cuda.__file__.startswith(root), _cuda.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print("ROOT", root, cs.smi_line(), flush=True)
path = _cuda._lib_path("flash_attention")
if path.exists():
    path.unlink()
_cuda.build(["flash_attention"], verbose=True)
usage = _cuda.ptxas_usage(_cuda.LOGS["flash_attention"])
names = ka.kernel_names(usage)
print("FLASH_REGS " + json.dumps({names[k]: u for k, u in usage.items()}),
      flush=True)
listing = ka.sass_listing("flash_attention")
sass = ka.count_ops(listing, "flash_kernel", ("HGMMA", "HMMA", "FFMA", "LDS"))
for h, body in ka._functions(listing):    # an older tree has no count_forms
    if h.group(1) in sass:
        sass[h.group(1)]["TF32_MMA"] = len(re.findall(cs.TF32_MMA, body))
names = ka.kernel_names(sass)
print("FLASH_SASS " + json.dumps({names[k]: c for k, c in sass.items()}),
      flush=True)
# the f32 kernels' instruction mix: their 16 most frequent opcodes
mix = {}
for h, body in ka._functions(listing):
    name = ka.kernel_names([h.group(1)])[h.group(1)]
    if "flash_kernel" in name and "wgmma" not in name:
        found = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9.]*)", body)
        mix[name] = dict(total=len(found), **{
            op: found.count(op) for op in sorted(set(found),
                                                 key=found.count)[-16:]})
print("FLASH_SASS_OPS " + json.dumps(mix), flush=True)
# this tree's float32 design, as its SASS shows it
tf32 = sum(c["TF32_MMA"] for c in sass.values())
cs.FLASH_DESIGN = {**cs.FLASH_DESIGN, torch.float32: (
    "tensor cores (TF32 products in its SASS)" if tf32 else
    "CUDA cores (no TF32 product in its SASS)")}
gen = torch.Generator(device="cuda").manual_seed(0)
for fc in cs.FLASH_CASES:
    if fc[-1] == torch.float32:
        rec = cs.check_flash(*fc, gen)
        torch.cuda.empty_cache()
        if not rec["ok"]:
            sys.exit(f"flash case outside tolerance: {rec['case']}")
if not realize:
    sys.exit(0)
from amq_tpu_torch.cli import quantize
from amq_tpu_torch.evaluation.metrics import get_bits_usage
from amq_tpu_torch.models.config import cycled_arch, get_config
cfg = get_config(cs.EVAL_MODEL)
arch = cycled_arch(cfg.num_layers)
bits = get_bits_usage(arch, cfg.topology())
with tempfile.TemporaryDirectory() as tmp:
    stats = os.path.join(tmp, "arch.stats")
    with open(stats, "w") as f:
        json.dump({"archive": [[arch, 0.0, bits]], "candidates": []}, f)
    counted = hasattr(fa.flash_attention, "f32_launches")
    for method in ("gptq", "awq"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = quantize.main([
            "--model_name", cfg.name, "--synthetic", "--load", stats,
            "--method", method, "--target_bits", str(bits),
            "--target_bits_offset", "0.5", "--eval_dataset", "synthetic",
            "--n_sample", str(cs.REAL_N), "--seqlen", str(cs.REAL_SEQ),
            "--batch_size", str(cs.REAL_BATCH), "--save_path", tmp])
        wall = time.perf_counter() - t0
        rec = dict(root=root, method=method, depth=cfg.num_layers,
                   ppl=res[0]["ppl"]["synthetic"], stage_s=res[0]["stage_s"],
                   wall_s=wall,
                   flash=fa.flash_attention.launches,
                   flash_f32=(fa.flash_attention.f32_launches if counted
                              else None),
                   reckoned=cs.reckon_realize(method, cfg.num_layers))
        print("REALIZE_AB " + json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
"""


def run(root: str, realize: bool = False) -> None:
    """One root's child process; raises if it fails."""
    subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root),
                    SMOKE, "1" if realize else "0"], check=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    realize = "--realize" in argv
    roots = [a for a in argv if a != "--realize"]
    if not roots:
        raise SystemExit("usage: python -m amq_tpu_torch.probes.flash_ab "
                         "[--realize] ROOT [ROOT ...]")
    for root in roots:
        run(root, realize)


if __name__ == "__main__":
    main()
