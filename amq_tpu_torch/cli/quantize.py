"""Stage 4 -- realize searched architectures with real PTQ and report
perplexity (PyTorch/CUDA port).

Loads a search archive (``iter_N.stats`` of ``cli.search``), keeps the
architectures inside the target-bits window, picks candidates (the ASF
pick with weights [0, target]: lowest bits usage in the window; or with
``--high_tradeoff`` the knee points of the in-window front), quantizes the
dense model with ``--method`` (fp16 | awq | gptq | owq | hqq) at each
pick's per-layer bits and writes every dataset's perplexity to
``{save_path}/{method}_results.json``.  OWQ's bit count carries its +0.1
bits of float outliers.  Each result also carries the seconds of each
realization stage (calibration forwards, Hessians, quantization,
propagation, perplexity).

    python -m amq_tpu_torch.cli.quantize --model_name Llama-2-7b-hf \\
        --synthetic --load search_out/iter_200.stats --method gptq
"""

from __future__ import annotations

import copy
import json

import numpy as np

from .common import (base_parser, compute_dtype, dump_json, load_model,
                     load_tokens, setup_torch)


def select_candidates(archive, target_bits: float, offset: float, n: int,
                      method: str, high_tradeoff: bool = False):
    """Window filter and ASF pick; with ``high_tradeoff`` the knee
    points of the in-window front instead."""
    archs = [v[0] for v in archive]
    metric = np.array([float(v[1]) for v in archive])
    bits = np.array([float(v[2]) for v in archive])
    if method == "owq":
        bits = bits + 0.1
    order = np.argsort(metric, kind="stable")
    metric, bits = metric[order], bits[order]
    archs = [archs[i] for i in order]
    in_win = (bits > target_bits - offset) & (bits < target_bits + offset)
    idx = np.where(in_win)[0]
    if idx.size == 0:
        raise SystemExit(f"no archs within {target_bits}+-{offset}")
    if high_tradeoff:
        from ..search.decision import high_tradeoff_points
        F = np.column_stack([metric[idx], bits[idx]])
        knees = high_tradeoff_points(F, n_survive=min(n, idx.size))
        pick = idx[np.asarray(knees, int)]
    else:
        # ASF with weights [0, target]: rank by bits usage alone
        asf = np.column_stack([metric[idx] * 0.0,
                               bits[idx] * target_bits]).max(1)
        pick = idx[np.argsort(asf, kind="stable")[:n]]
    return [(archs[i], metric[i], bits[i]) for i in pick]


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--load", type=str, required=True,
                   help="iter_N.stats archive of the search stage")
    p.add_argument("--method", type=str, default="gptq",
                   choices=["fp16", "awq", "gptq", "owq", "hqq"])
    p.add_argument("--target_bits", type=float, default=3.0)
    p.add_argument("--target_bits_offset", type=float, default=0.05)
    p.add_argument("--num_of_candidates", type=int, default=1)
    p.add_argument("--high_tradeoff", action="store_true",
                   help="select the knee points of the in-window front")
    p.add_argument("--eval_dataset", type=str, nargs="+",
                   default=["wikitext2", "c4"])
    p.add_argument("--save_path", type=str, default="quantize_out")
    args = p.parse_args(argv)
    setup_torch()

    from ..evaluation import Evaluator
    from ..evaluation.metrics import get_bits_usage
    from ..quantization import get_quantized_params
    from ..quantization.calib import StageClock

    with open(args.load) as f:
        blob = json.load(f)
    archive = blob["archive"] + blob["candidates"]

    cfg, params = load_model(args)
    datasets = {d: load_tokens(argparse_clone(args, dataset=d), cfg,
                               train=False)
                for d in args.eval_dataset}
    selected = select_candidates(archive, args.target_bits,
                                 args.target_bits_offset,
                                 args.num_of_candidates, args.method,
                                 high_tradeoff=args.high_tradeoff)
    for arch, metric, bits in selected:
        print(f"selected arch: loss={metric:.4f} bits={bits:.4f}")

    # local:<file> runs calibrate on the same corpus (train split); the
    # hub datasets keep each method's own calibration set
    calib_tokens = None
    if args.dataset.startswith("local:"):
        calib_tokens = load_tokens(args, cfg, train=True)

    clock = None

    def quantize_fn(p_, c, arch, method):
        if method == "fp16":
            return p_
        kwargs = {} if method == "hqq" else {"clock": clock}
        return get_quantized_params(
            p_, c, method, arch,
            avg_bits=get_bits_usage(arch, c.topology(), args.group_size),
            group_size=args.group_size, calib_tokens=calib_tokens,
            synthetic_calib=args.synthetic, n_samples=args.n_sample,
            **kwargs)

    ev = Evaluator(cfg, dense_params=params, datasets=datasets, search=False,
                   group_size=args.group_size, batch_size=args.batch_size,
                   quantize_fn=quantize_fn, compute_dtype=compute_dtype(args),
                   device=args.device)
    results = []
    for arch, metric, bits in selected:
        # ev.eval(arch, method), its two steps timed apart
        clock = StageClock(ev.device)
        with clock("realization"):
            qparams = ev.sample(arch, args.method)
        with clock("perplexity"):
            ppl = {name: ev.eval_ppl(qparams, toks)
                   for name, toks in ev.datasets.items()}
        del qparams
        usage = get_bits_usage(arch, cfg.topology(), args.group_size)
        stages = dict(clock.seconds)
        print(f"bits={usage:.4f} ppl={ppl} stages_s={stages}", flush=True)
        results.append({"arch": arch, "method": args.method, "bits": usage,
                        "ppl": ppl, "stage_s": stages})
    dump_json(results, f"{args.save_path}/{args.method}_results.json")
    return results


def argparse_clone(args, **over):
    a = copy.copy(args)
    for k, v in over.items():
        setattr(a, k, v)
    return a


if __name__ == "__main__":
    main()
