"""Per-layer shares read from what a tracer recorded.

Each reader takes a :class:`~.profiling.Tracer` that keeps its spans
(by default the program's, :data:`~.profiling.TRACER`, which records only
while a ``torch.profiler`` profile runs, so its spans and counters cover
exactly the profiled slice) and returns a percentage, or None when the
tracer holds nothing to read.  :func:`readings` gives every reading that
has something to read, under the name a per-layer metric of the serving
loop or the evaluator would carry.

``host_gap_share`` under the profiler is mostly the profiler's own cost:
on one H100 the first graph launch after a read-back took 2.4 / 3.5 ms
(median, Mistral-7B with 8 / 32 chat slots) under the profiler and 0.07 /
0.32 ms without it; the gap read 6.9 / 6.4 % of a traced slice and
2.7 / 2.3 % of an untraced one.  So a host-side change moves a traced
reading by the part outside the launches.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import profiling


def _tracer(tracer):
    return profiling.TRACER if tracer is None else tracer


def prefill_pad_share(tracer=None) -> Optional[float]:
    """Share of the prefill rows computed (``serve.prefill_rows``: bucket
    or chunk rows) that were padding (not ``serve.prefill_tokens``)."""
    c = _tracer(tracer).counters
    rows = c.get("serve.prefill_rows", 0)
    if not rows:
        return None
    return 100.0 * (rows - c.get("serve.prefill_tokens", 0)) / rows


def decode_yield(tracer=None) -> Optional[float]:
    """Share of the slot-steps the decode chunks computed
    (``serve.decode_slot_steps``: every slot at every step replayed) that
    gave a request a token (``serve.decode_tokens``)."""
    c = _tracer(tracer).counters
    steps = c.get("serve.decode_slot_steps", 0)
    if not steps:
        return None
    return 100.0 * c.get("serve.decode_tokens", 0) / steps


def gaps(spans) -> List[Tuple[int, int]]:
    """The ``(start_ns, end_ns)`` intervals in which the host held the
    device empty after reading it dry: from the end of the first
    ``serve.readback`` after a launch to the end of the next
    ``serve.launch`` (the replay that hands the device its next work)."""
    marks = sorted((s.start_ns if s.name == "serve.launch" else s.end_ns,
                    s.name, s.end_ns) for s in spans
                   if s.name in ("serve.readback", "serve.launch"))
    out, dry = [], None
    for t, name, end in marks:
        if name == "serve.readback":
            dry = t if dry is None else dry
        elif dry is not None:
            out.append((dry, end))
            dry = None
    return out


def split(spans, intervals) -> Dict[str, float]:
    """Seconds of ``intervals`` by the name of the innermost span (the
    latest begun) that covers each piece, ``"no span"`` where none does;
    ``serve.queued`` spans, which cover no host work, are left out."""
    spans = [s for s in spans if s.name != "serve.queued"]
    out = defaultdict(float)
    for a, b in intervals:
        inner = [s for s in spans if s.start_ns < b and s.end_ns > a]
        cuts = sorted({a, b} | {min(b, max(a, x)) for s in inner
                                for x in (s.start_ns, s.end_ns)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            cover = [s for s in inner if s.start_ns <= mid <= s.end_ns]
            name = (max(cover, key=lambda s: s.start_ns).name if cover
                    else "no span")
            out[name] += (hi - lo) / 1e9
    return dict(out)


def host_gap_share(slice_s: Optional[float],
                   tracer=None) -> Optional[float]:
    """Share of a slice of ``slice_s`` seconds taken by :func:`gaps`."""
    spans = _tracer(tracer).spans
    if not slice_s or not any(s.name in ("serve.readback", "serve.launch")
                              for s in spans):
        return None
    return 100.0 * sum(b - a for a, b in gaps(spans)) / 1e9 / slice_s


def ttft_queued_share(tracer=None) -> Optional[float]:
    """Share of the time to first token spent queued, over the requests
    whose submission and first token both were recorded: their
    ``serve.queued`` spans (submission to the start of the prefill) over
    submission to the end of their first uid'd ``serve.bookkeeping`` (the
    first token handed to the request)."""
    spans = _tracer(tracer).spans
    queued = {s.uid: s for s in spans if s.name == "serve.queued"}
    first = {}
    for s in spans:
        if (s.name == "serve.bookkeeping" and s.uid in queued
                and s.uid not in first):
            first[s.uid] = s.end_ns
    wait = sum(queued[u].end_ns - queued[u].start_ns for u in first)
    ttft = sum(t - queued[u].start_ns for u, t in first.items())
    return 100.0 * wait / ttft if ttft else None


def dequant_yield(tracer=None) -> Optional[float]:
    """Linear weights the evaluated architectures need (``eval.linears``:
    layers × sites each) over the dequantization kernel's launches inside
    their ``eval.arch`` spans: 100 when each weight is dequantized once
    per architecture."""
    t = _tracer(tracer)
    launches = sum((s.launches or {}).get("dequantize_kn.launches", 0)
                   for s in t.spans if s.name == "eval.arch")
    linears = t.counters.get("eval.linears", 0)
    return 100.0 * linears / launches if launches and linears else None


def readings(slice_s: Optional[float] = None,
             tracer=None) -> Dict[str, float]:
    """Every reading above that has something to read, by metric name."""
    got = {"prefill_pad_share.serve": prefill_pad_share(tracer),
           "decode_yield.serve": decode_yield(tracer),
           "host_gap_share.serve": host_gap_share(slice_s, tracer),
           "ttft_queued_share.serve": ttft_queued_share(tracer),
           "dequant_yield.eval": dequant_yield(tracer)}
    return {k: v for k, v in got.items() if v is not None}
