"""Readings that set a cell's limits: the program's and the control's.

    python3 -m perfbench.calibrate --workload <cell> --seeds <a,b,...> --seconds <s>

For each seed, in one process: one run of the cell with a short window
at the cell's own load and the control (the reference with every linear
in float8 e4m3) in the program's place in the cell's comparison, so its
``correct`` is the control's and has to read false.  Beside it, from the
same run, the program's own reading (the widest gap of the served
tokens; for an evaluation cell the gap of the program's loss).  One JSON
line per seed.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from perfbench import bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = bench.cell(args.workload)
    loop = bench.module(bench.ROOT, "loops", cell["traffic_data"]["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = loop.run(cell, seed, args.seconds, False, "cuda",
                         time.perf_counter(), control=True)
        m = bench.read_metrics(cell["end_to_end"], run)
        print("CALIBRATE " + json.dumps(dict(
            workload=args.workload, seed=seed, control_correct=run.correct,
            program={k: v["value"] for k, v in run.program_checks.items()},
            control={k: v["value"] for k, v in run.checks.items()},
            attempted=run.attempted,
            **{k: v["value"] for k, v in m.items()})), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
