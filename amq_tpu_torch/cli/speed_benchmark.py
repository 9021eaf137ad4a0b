"""Stage 5 -- mixed-bit serving speed benchmark (PyTorch/CUDA port).

Builds the per-bit HQQ proxies (or reads them from ``--proxy_path``),
stacks them for an architecture (or the cycled 2/3/4 default), merges
equal-width containers and measures the TPS / GEMV / GEMM / TTFT modes,
the CONTINUOUS mode (``--n_requests`` streamed through ``--n_slots``
slot-batched decoding) and peak device memory on the card.  With
``--device cpu`` only CONTINUOUS runs: once, untimed, its counts and no
rate.  ``--method owq`` realizes the architecture with OWQ in packed
serving form (``--target_bits`` sets the outlier budget; synthetic
calibration under ``--synthetic``) and serves it through the per-layer
forward, each linear a ``quant_matmul`` over its non-outlier columns plus
a float outlier product (TPS / GEMV / GEMM / TTFT only).

    python -m amq_tpu_torch.cli.speed_benchmark --model_name Llama-2-7b-hf \
        --synthetic --modes TPS CONTINUOUS --n_slots 4 --n_requests 16
"""

from __future__ import annotations

import json
import time

import torch

from .common import (base_parser, dump_json, load_model, proxy_factories,
                     setup_torch)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--arch_json", type=str, default="",
                   help="architecture dict JSON (else cycle 2/3/4)")
    p.add_argument("--method", type=str, default="hqq", choices=["hqq", "owq"])
    p.add_argument("--target_bits", type=float, default=3.0,
                   help="average bits of the OWQ outlier budget")
    p.add_argument("--proxy_path", type=str, default="",
                   help="dir with per-bit proxies (cli.proxy)")
    p.add_argument("--prompt_len", type=int, default=64)
    p.add_argument("--gen_len", type=int, default=128)
    p.add_argument("--modes", type=str, nargs="+",
                   default=["TPS", "GEMV", "GEMM", "TTFT"],
                   help="also: CONTINUOUS (slot-batched throughput)")
    p.add_argument("--n_slots", type=int, default=4)
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--no_kernels", action="store_true",
                   help="dequantize-then-matmul instead of the CUDA kernels")
    p.add_argument("--native_pack", action="store_true",
                   help="native 3-bit packing instead of 4-bit containers")
    p.add_argument("--head_bits", type=int, default=8,
                   help="lm_head serving width; 0 keeps the dense head")
    p.add_argument("--save_path", type=str, default="speed_out")
    p.set_defaults(batch_size=1)
    args = p.parse_args(argv)

    from ..models.config import cycled_arch
    from ..models.stacked import SERVE_CONTAINERS, merge_containers, stack_proxies
    from ..models.transform import quantize_model
    from ..core.device import synchronize
    from ..serving.benchmark import (PeakMemTracker, benchmark_continuous,
                                     benchmark_speed, serve_continuous)
    from ..serving.engine import Engine

    t0 = time.perf_counter()
    cfg, params = load_model(args)
    bits_range = [2, 3, 4]
    if args.arch_json:
        with open(args.arch_json) as f:
            arch = json.load(f)
    else:
        arch = cycled_arch(cfg.num_layers, bits_range)
    if args.method == "owq":
        return _owq_speed(args, cfg, params, arch, t0)
    if args.proxy_path:
        proxies = proxy_factories(args, cfg, bits_range)
    else:
        proxies = [(lambda b=b: quantize_model(params, cfg, b,
                                               group_size=args.group_size))
                   for b in bits_range]
    model = stack_proxies(
        proxies, bits_range, arch,
        container_bits=None if args.native_pack else SERVE_CONTAINERS,
        head_bits=args.head_bits or None)
    if model.uniform_select:
        model = merge_containers(model)
    del params, proxies
    eng = Engine(model, cfg, batch_size=args.batch_size,
                 max_len=args.prompt_len + args.gen_len + 8,
                 compute_dtype=torch.bfloat16,
                 use_kernels=not args.no_kernels, device=args.device)
    on_card = eng.device.type == "cuda"
    synchronize(eng.device)
    if on_card:
        torch.cuda.empty_cache()
    results = {"setup_s": time.perf_counter() - t0}
    print(f"setup: {results['setup_s']:.1f} s")

    mem = PeakMemTracker(eng.device) if on_card else None
    for mode in args.modes:
        if mode == "CONTINUOUS":
            run = benchmark_continuous if on_card else serve_continuous
            results[mode] = run(
                model, cfg, n_slots=args.n_slots, n_requests=args.n_requests,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                max_len=args.prompt_len + args.gen_len + 8,
                use_kernels=not args.no_kernels, device=eng.device)
        else:
            results[mode] = benchmark_speed(eng, mode,
                                            prompt_len=args.prompt_len,
                                            gen_len=args.gen_len)
        print(f"{mode}: {results[mode]}")
    if on_card:
        results["peak_mem_gib"], results["peak_mem_kind"] = mem.result()
        results["device"] = torch.cuda.get_device_name(eng.device)
    else:
        results["device"] = str(eng.device)
    dump_json(results, f"{args.save_path}/{cfg.name}_speed.json")
    return results


def _owq_speed(args, cfg, params, arch, t0):
    """OWQ packed serving: realize ``arch`` with
    ``owq_quantize_model(packed=True)`` and time the per-layer forward."""
    from ..core.device import synchronize
    from ..quantization import get_quantized_params
    from ..serving.benchmark import PeakMemTracker, benchmark_speed
    from ..serving.engine import Engine

    if params["embed"].device.type != "cuda":
        raise RuntimeError("OWQ serving speed needs the CUDA device; the "
                           f"model is on {params['embed'].device}")
    setup_torch()
    qparams = get_quantized_params(
        params, cfg, "owq", arch, avg_bits=args.target_bits,
        group_size=args.group_size, synthetic_calib=args.synthetic,
        n_samples=args.n_sample, packed=True)
    del params
    eng = Engine(qparams, cfg, batch_size=args.batch_size,
                 max_len=args.prompt_len + args.gen_len + 8,
                 compute_dtype=torch.bfloat16,
                 use_kernels=not args.no_kernels, device=args.device)
    synchronize(eng.device)
    results = {"method": "owq", "target_bits": args.target_bits,
               "setup_s": time.perf_counter() - t0}
    print(f"setup: {results['setup_s']:.1f} s")
    torch.cuda.empty_cache()
    mem = PeakMemTracker(eng.device)
    for mode in args.modes:
        if mode == "CONTINUOUS":
            continue                      # the stacked model's path only
        results[mode] = benchmark_speed(eng, mode, prompt_len=args.prompt_len,
                                        gen_len=args.gen_len)
        print(f"{mode}: {results[mode]}")
    results["peak_mem_gib"], results["peak_mem_kind"] = mem.result()
    results["device"] = torch.cuda.get_device_name(eng.device)
    dump_json(results, f"{args.save_path}/{cfg.name}_owq_speed.json")
    return results


if __name__ == "__main__":
    main()
