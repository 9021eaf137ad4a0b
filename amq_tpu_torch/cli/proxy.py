"""Stage 1 -- uniform-bit HQQ quantization proxies (PyTorch/CUDA port).

Quantizes every decoder linear at each of ``--nbits`` (group
``--group_size``) and saves each proxy as ``qmodel.npz`` +
``manifest.json`` under ``{save_path}/{model}_{b}bit_{g}gs_1axis``, the
JAX package's format and names, which the sensitivity, search and speed
CLIs read with ``--proxy_path``.

    python -m amq_tpu_torch.cli.proxy --model_name Llama-2-7b-hf \\
        --synthetic --nbits 2 3 4 --save_path proxies
"""

from __future__ import annotations

import time

import torch

from .common import base_parser, load_model, proxy_path


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nbits", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--no_optimize", action="store_true",
                   help="skip the proximal zero-point solver")
    p.add_argument("--meta_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="scale/zero storage dtype")
    args = p.parse_args(argv)

    from ..models.transform import quantize_model
    from ..utils.checkpoint import save_quantized

    cfg, params = load_model(args)
    paths = []
    for b in args.nbits:
        t0 = time.perf_counter()
        q = quantize_model(params, cfg, b, group_size=args.group_size,
                           optimize=not args.no_optimize,
                           meta_dtype=getattr(torch, args.meta_dtype))
        out = proxy_path(args.save_path, cfg, b, args.group_size)
        save_quantized(q, cfg, out, extra_meta={"nbits": b})
        del q
        paths.append(out)
        print(f"saved {out} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"paths": paths, "model": cfg.name}


if __name__ == "__main__":
    main()
