"""Stage 2 -- layer-wise sensitivity table for space pruning (PyTorch/CUDA
port).

Builds the evaluator (dense fp16 logit cache on the card, 2/3/4-bit HQQ
proxies stacked into one switch model), runs the 2-bit probe of every
(block, linear) site against the all-4-bit baseline, and writes the JAX
package's JSON schema: ``{model}_dataset_{d}_n_sample_{n}_seqlen_{s}.json``
with a ``loss["{block}.{linear}"]`` table.

    python -m amq_tpu_torch.cli.sensitivity --model_name Llama-2-7b-hf \\
        --synthetic --n_sample 2 --batch_size 2
"""

from __future__ import annotations

import os
import time

from .common import (base_parser, compute_dtype, data_group, dump_json,
                     is_writer, load_model, load_tokens, proxy_factories,
                     setup_torch)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--proxy_path", type=str, default="",
                   help="dir with per-bit proxies (cli.proxy); else they "
                        "are quantized in-process")
    p.add_argument("--save_path", type=str, default="sensitivity")
    args = p.parse_args(argv)
    setup_torch()

    from ..evaluation import Evaluator
    from ..evaluation.sensitivity import linear_sensitivity

    cfg, params = load_model(args)
    tokens = load_tokens(args, cfg, train=True)
    proxies = proxy_factories(args, cfg) if args.proxy_path else None
    ev = Evaluator(cfg, dense_params=params, proxies=proxies,
                   datasets={args.dataset: tokens},
                   group_size=args.group_size, batch_size=args.batch_size,
                   compute_dtype=compute_dtype(args), device=args.device,
                   data_group=data_group(args))
    del params            # the evaluator holds no reference to it
    print(f"evaluator: dense logits {ev.setup_s['dense_logits']:.1f} s, "
          f"proxies {ev.setup_s['proxies']:.1f} s", flush=True)
    t0 = time.perf_counter()
    table = linear_sensitivity(ev, args.dataset, progress=True)
    probes_s = time.perf_counter() - t0
    print(f"probes: {len(table['loss'])} in {probes_s:.1f} s "
          f"({probes_s / len(table['loss']):.3f} s/probe)", flush=True)
    ds_tag = os.path.basename(args.dataset.replace("local:", ""))
    out = os.path.join(
        args.save_path,
        f"{cfg.name}_dataset_{ds_tag}_n_sample_{args.n_sample}"
        f"_seqlen_{args.seqlen}.json")
    if is_writer(args):
        dump_json(table, out)
    return {"path": out, "table": table, "probes_s": probes_s, **ev.setup_s}


if __name__ == "__main__":
    main()
