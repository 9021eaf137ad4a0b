"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, graph captures, the ramp), then a window
of ``--seconds``, then the check against the plain reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit, also printed as the last lines of standard error.  Without a CUDA
device, or with fewer than the cell asks for, or if the window leaves a
JAX module loaded, it prints no result and exits non-zero.

Build and kernel caches stay at fixed paths inside the checkout: the
port's own (``amq_tpu_torch/_build``) and ``.perfbench_cache/`` for any
other (Triton, torch extensions, CUDA's JIT cache).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    cache = CHECKOUT / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    import torch
    from perfbench import bench, trace
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{cell['chips']} CUDA devices wanted, "
                     f"{torch.cuda.device_count()} found")
    from amq_tpu_torch.ops import _cuda
    # every library the serving and evaluation paths load, built together
    _cuda.build(("quant_matmul", "quant_matmul_tile", "decode_attention",
                 "flash_attention", "dequant"))
    loop = bench.module(bench.ROOT, "loops", cell["traffic_data"]["kind"])
    run = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    bad = bench.forbidden_modules()
    if bad:
        return _fail(f"modules loaded that no run may load: {bad}")
    names = cell["per_layer"] if args.trace else cell["end_to_end"]
    line = {"correct": bool(run.correct), "attempted": run.attempted,
            "failed": run.failed,
            "metrics": bench.read_metrics(names, run),
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"],
                       "memory_peak_bytes": run.memory_peak_bytes}}
    if args.trace:
        if not run.trace:
            return _fail("the trace holds no device operation")
        print(f"profiler stopped in {run.trace['stop_s']} s, read in "
              f"{run.trace['read_s']} s", file=sys.stderr, flush=True)
        line["device"].update(busy_s=run.trace["busy_s"],
                              window_s=run.trace["window_s"])
        line["breakdown"] = {"device_ops": trace.top(run.trace["group_s"]),
                             "idle_gaps": trace.top(run.trace["idle_s"])}
    line["checks"] = run.checks
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
