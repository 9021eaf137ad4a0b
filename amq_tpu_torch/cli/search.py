"""Stage 3 -- NSGA-II mixed-precision search (PyTorch/CUDA port).

The JAX CLI's flags and defaults (threshold 2.0, rbf surrogate, 200
iterations, DOE 250, 50 per iteration, populations 200/100, crossover 0.9,
mutation 0.1) and its ``search_out/iter_N.stats`` archive.  Needs a
sensitivity JSON (``cli.sensitivity``).

    python -m amq_tpu_torch.cli.search --model_name Llama-2-7b-hf \\
        --synthetic --sensitivity_json sensitivity/<file>.json
"""

from __future__ import annotations

import json
import time

from .common import (base_parser, compute_dtype, data_group, is_writer,
                     load_model, load_tokens, proxy_factories, setup_torch)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--sensitivity_json", type=str, required=True)
    p.add_argument("--sensitivity_threshold", type=float, default=2.0)
    p.add_argument("--proxy_path", type=str, default="",
                   help="dir with per-bit proxies (cli.proxy); else they "
                        "are quantized in-process")
    p.add_argument("--predictor", type=str, default="rbf",
                   choices=["rbf", "mlp"])
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--n_doe", type=int, default=250)
    p.add_argument("--n_iter", type=int, default=50)
    p.add_argument("--save_iter", type=int, default=10)
    p.add_argument("--ga_pop_size", type=int, default=200)
    p.add_argument("--subset_pop_size", type=int, default=100)
    p.add_argument("--crossover_prob", type=float, default=0.9)
    p.add_argument("--mut_prob", type=float, default=0.1)
    p.add_argument("--max_value", type=float, default=10.0)
    p.add_argument("--save_path", type=str, default="search_out")
    p.add_argument("--resume_path", type=str, default="")
    args = p.parse_args(argv)
    setup_torch()

    import numpy as np

    from ..evaluation import Evaluator
    from ..search import Search, SearchSpace, prune_by_sensitivity

    with open(args.sensitivity_json) as f:
        sensitivity = json.load(f)
    pass_list = prune_by_sensitivity(sensitivity, args.sensitivity_threshold)
    print(f"pass_linear_list ({len(pass_list)}): {pass_list}")

    t0 = time.perf_counter()
    cfg, params = load_model(args)
    tokens = load_tokens(args, cfg, train=True)
    proxies = proxy_factories(args, cfg) if args.proxy_path else None
    ev = Evaluator(cfg, dense_params=params, proxies=proxies,
                   datasets={args.dataset: tokens},
                   group_size=args.group_size, batch_size=args.batch_size,
                   compute_dtype=compute_dtype(args), device=args.device,
                   data_group=data_group(args))
    del params            # the evaluator holds no reference to it
    setup_s = time.perf_counter() - t0
    space = SearchSpace(cfg.topology(), group_size=args.group_size,
                        pass_linear_list=pass_list,
                        rng=np.random.default_rng(args.seed))
    search = Search(
        ev, space, dataset=args.dataset, iterations=args.iterations,
        n_doe=args.n_doe, n_iter=args.n_iter, save_iter=args.save_iter,
        predictor=args.predictor, ga_pop_size=args.ga_pop_size,
        subset_pop_size=args.subset_pop_size,
        crossover_prob=args.crossover_prob, mut_prob=args.mut_prob,
        max_value=args.max_value,
        save_path=args.save_path if is_writer(args) else None,
        resume_path=args.resume_path or None, seed=args.seed)
    t1 = time.perf_counter()
    archive = search.search()
    search_s = time.perf_counter() - t1
    print(f"search: {len(archive)} archs in {search_s:.1f} s; "
          f"{search.n_evaluated} evaluated in {search.eval_seconds:.1f} s "
          f"({search.eval_seconds / max(search.n_evaluated, 1):.3f} s/arch)",
          flush=True)
    return {"archive": archive, "setup_s": setup_s, "search_s": search_s,
            "n_evaluated": search.n_evaluated,
            "eval_s": search.eval_seconds}


if __name__ == "__main__":
    main()
