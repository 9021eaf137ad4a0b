"""The port's span readings in one run of a benchmark cell, and the host
gap of a chat cell split by the serving loop's spans, with and without
the profiler.

One run of a ``perfbench`` cell (its loop, as ``perfbench.run`` runs it).
Traced (``TRACE`` 1): the spans ``utils.profiling.TRACER`` recorded over
the traced slice, every reading of ``utils.span_readings`` (the serving
loop's in a chat cell, ``dequant_yield.eval`` in the search cell), and
the card's idle in the slice by the innermost ``amq.*`` span at each idle
gap's middle.  Untraced (``TRACE`` 0): a plain ``Tracer(keep_spans=True)``
takes ``TRACER``'s place in the serving modules and records with the
clock alone (no profiler, no ``record_function``), and the window's last
``trace_seconds`` (the cell's traffic sets them) stand in for the slice.
Either way it prints one ``SERVE_SPANS`` line: the host gap's share (the
readings' ``gaps``) and its ``split`` by innermost span, the
``serve.launch`` spans' durations (all, and the first after each
read-back, which ends a gap), the cell's metrics, traced the readings,
and appends the line to ``OUT``::

    python -m amq_tpu_torch.probes.serve_spans CELL SEED SECONDS TRACE [OUT]

from the root of a checkout (it imports ``perfbench``), on the card.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

T_START = time.perf_counter()

#: an idle gap shorter than this is "between kernels" (perfbench.trace's
#: threshold)
BETWEEN_KERNELS_NS = 50_000


def _us(xs) -> dict:
    """Count, mean, median and 95th percentile of ``xs`` (ns) in µs."""
    if not xs:
        return dict(n=0)
    a = np.asarray(xs, np.float64) / 1e3
    return dict(n=len(xs), mean=float(a.mean()), p50=float(np.median(a)),
                p95=float(np.percentile(a, 95)))


def idle_by_span(events, slice_name: str = "perfbench.slice") -> dict:
    """Seconds of the slice in which no device operation ran, by the
    innermost (latest begun) ``amq.*`` span at each gap's middle, from
    ``perfbench.trace``'s ``(kind, start_ns, end_ns, name)`` events."""
    lo = hi = None
    dev, spans = [], []
    for kind, a, b, name in events:
        if kind == "device":
            dev.append((a, b))
        elif name == slice_name:
            lo, hi = a, b
        elif kind == "span" and name.startswith("amq."):
            spans.append((a, b, name[4:]))
    out = defaultdict(float)
    if lo is None:
        return {}
    end = lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in dev
                       if b > lo and a < hi) + [(hi, hi)]:
        if a > end:
            mid = (a + end) // 2
            cover = [s for s in spans if s[0] <= mid <= s[1]]
            label = max(cover)[2] if cover else "no amq span"
            if a - end < BETWEEN_KERNELS_NS:
                label = "between kernels"
            out[label] += (a - end) / 1e9
        end = max(end, b)
    return dict(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cell_name, seed, seconds, traced = argv[:4]
    dest = Path(argv[4] if len(argv) > 4 else "chiprun_out/serve_spans.jsonl")
    traced = bool(int(traced))
    import torch
    from perfbench import bench, run as prun, trace as ptrace
    prun._caches()
    if not torch.cuda.is_available():
        raise RuntimeError("the serving-span probe needs a card")
    from amq_tpu_torch.evaluation import evaluator
    from amq_tpu_torch.ops import _cuda
    from amq_tpu_torch.serving import batched, engine, graphs
    from amq_tpu_torch.utils import profiling, span_readings
    _cuda.build(("quant_matmul", "quant_matmul_tile", "decode_attention",
                 "flash_attention", "dequant"))
    cell = bench.cell(cell_name)
    events = {}
    if traced:
        summarize = ptrace.summarize

        def keep(evs, *a, **k):
            events["all"] = evs
            return summarize(evs, *a, **k)
        ptrace.summarize = keep
        tracer = profiling.TRACER
    else:
        tracer = profiling.Tracer(keep_spans=True)
        for mod in (profiling, batched, engine, graphs, evaluator):
            mod.TRACER = tracer
    loop = bench.module(bench.ROOT, "loops", cell["traffic_data"]["kind"])
    run = loop.run(cell, int(seed), float(seconds), traced, device="cuda",
                   t_start=T_START)
    spans = tracer.spans
    if traced:
        slice_s = run.trace["window_s"]
    else:
        # the window's last trace_seconds, from the end of the first
        # iteration that ends there (as perfbench.trace.Slice opens)
        t1 = [it["t1"] for it in run.iterations]
        t_open = t1[-1] - run.window_s
        opens = max(float(seconds) - cell["traffic_data"]["trace_seconds"],
                    0.0)
        lo = round(next(t for t in t1 if t - t_open >= opens) * 1e9)
        hi = round(t1[-1] * 1e9)
        spans = [s for s in spans if s.start_ns >= lo and s.end_ns <= hi]
        slice_s = (hi - lo) / 1e9
    held = span_readings.gaps(spans)
    ends = {b for _, b in held}
    launches = [s for s in spans if s.name == "serve.launch"]
    names = cell["per_layer"] if traced else cell["end_to_end"]
    out = dict(
        cell=cell_name, seed=int(seed), traced=traced,
        correct=bool(run.correct), slice_s=slice_s,
        host_gap_share=100.0 * sum(b - a for a, b in held) / 1e9 / slice_s,
        gaps=len(held),
        split_pct={k: 100.0 * v / slice_s for k, v in sorted(
            span_readings.split(spans, held).items(), key=lambda kv: -kv[1])},
        launch_us=_us([s.end_ns - s.start_ns for s in launches]),
        first_launch_us=_us([s.end_ns - s.start_ns for s in launches
                             if s.end_ns in ends]),
        readback_us=_us([s.end_ns - s.start_ns for s in spans
                         if s.name == "serve.readback"]),
        metrics={k: v["value"] for k, v in
                 bench.read_metrics(names, run).items()})
    if traced:
        out["readings"] = span_readings.readings(slice_s, tracer)
    if traced and "all" in events:
        out["idle_pct_by_span"] = {
            k: 100.0 * v / slice_s for k, v in sorted(
                idle_by_span(events["all"]).items(), key=lambda kv: -kv[1])}
    line = json.dumps(out)
    print("SERVE_SPANS " + line, flush=True)
    dest.parent.mkdir(parents=True, exist_ok=True)
    with open(dest, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
