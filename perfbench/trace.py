"""The device trace of a slice of the window (``--trace 1``).

``torch.profiler.profile`` (Kineto, CUPTI on the card) records CPU ops,
the benchmark's own spans (``record_function("perfbench.<name>")``) and
every kernel, copy and set on the device, also inside CUDA graph replays.
Once the window has closed, the slice's events (``profile.events()``)
are reduced to ``(kind, start_ns, end_ns, name)`` tuples, kind
``device``, ``span`` or ``cpu``.

:func:`summarize` reduces them to what the metrics read: the slice's
length (the ``perfbench.slice`` span), the seconds in which some device
operation ran (the union of their intervals), seconds by kernel group
(``kernels/<group>.json``; unmatched names fall in ``other``), and the
idle time between device operations by what the host was doing then
(the innermost benchmark span and the innermost CPU op at the gap's
middle).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

#: idle gaps shorter than this sit between kernels of one host call and
#: are counted under one label, unlabelled
GAP_LABEL_S = 50e-6
#: how many earlier CPU ops a gap's label looks back through
_LOOK_BACK = 4000


def _kind(ev) -> str:
    from torch.autograd import DeviceType
    if ev.is_user_annotation:
        # a span's copy on the device timeline is no device operation
        return "span" if ev.device_type == DeviceType.CPU else "skip"
    return "device" if ev.device_type == DeviceType.CUDA else "cpu"


class DeviceTrace:
    """Start, stop and read the profiler.  ``read()`` leaves in ``events``
    the events as ``(kind, start_ns, end_ns, name)``; ``stop_s`` and
    ``read_s`` are the seconds that stopping and reading took."""

    def __init__(self):
        self.events = None
        self.stop_s = self.read_s = None
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> None:
        t0 = time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - t0

    def read(self) -> None:
        t0 = time.perf_counter()
        events = []
        for ev in self._prof.events():
            kind = _kind(ev)
            if kind != "skip":
                r = ev.time_range
                events.append((kind, round(r.start * 1e3), round(r.end * 1e3),
                               ev.name))
        self.events = events
        self._prof = None
        self.read_s = time.perf_counter() - t0


class Slice:
    """The traced part of a window (``--trace 1``): the last ``seconds``
    of a window of ``window`` seconds, from the end of the first step that
    ends ``window - seconds`` into it to the window's close, so that
    stopping the profiler and reading its events fall after the window.
    The profiler is started and stopped once when the slice is made (its
    first start imports and initialises for seconds): that is set-up.
    Inactive when ``on`` is false."""

    def __init__(self, on: bool, seconds: float, window: float):
        self.trace = DeviceTrace() if on else None
        self.opens_at = max(window - seconds, 0.0)
        self._span = None
        if self.trace is not None:
            self.trace.start()
            self.trace.stop()
            self.trace.read()
            self.trace.events = None

    @property
    def active(self) -> bool:
        return self._span is not None

    def step_ended(self, elapsed: float) -> None:
        """A step of the window ended ``elapsed`` seconds into it."""
        if (self.trace is not None and self.trace.events is None
                and self._span is None and elapsed >= self.opens_at):
            self.trace.start()
            self._span = span("slice")
            self._span.__enter__()

    def close(self) -> None:
        """After the window: stop the profiler and read its events."""
        if self.active:
            self._span.__exit__(None, None, None)
            self._span = None
            self.trace.stop()
            self.trace.read()

    def summary(self, root) -> Optional[dict]:
        """:func:`summarize` of the slice, None when nothing was traced."""
        if self.trace is None or self.trace.events is None:
            return None
        from perfbench import bench
        out = summarize(self.trace.events, bench.kernel_groups(root))
        if out is not None:
            out.update(stop_s=self.trace.stop_s, read_s=self.trace.read_s)
        return out


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a named CPU range in the trace (free when no
    profiler runs)."""
    from torch.profiler import record_function
    with record_function(f"perfbench.{name}"):
        yield


def summarize(events, groups, slice_name: str = "perfbench.slice") -> Optional[dict]:
    """``{"window_s", "busy_s", "group_s", "idle_s"}`` of the events
    (``(kind, start_ns, end_ns, name)``) inside the ``slice_name`` span;
    None without that span or without a device operation in it."""
    dev, cpu, spans = [], [], []
    lo = hi = None
    for kind, start, end, name in events:
        if kind == "device":
            dev.append((start, end, name))
        elif name == slice_name:
            lo, hi = start, end
        elif kind == "span":
            if name.startswith("perfbench."):
                spans.append((start, end, name[len("perfbench."):]))
        elif end > start:
            cpu.append((start, end, name))
    if lo is None:
        return None
    dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev
                 if b > lo and a < hi)
    if not dev:
        return None
    group_s: Dict[str, float] = defaultdict(float)
    cache: Dict[str, str] = {}
    for a, b, n in dev:
        g = cache.get(n)
        if g is None:
            g = cache[n] = next((name for name, pats in groups
                                 if any(p.search(n) for p in pats)), "other")
        group_s[g] += (b - a) / 1e9
    busy, gaps, end = 0, [], lo
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        s = (b - a) / 1e9
        if s < GAP_LABEL_S:
            idle["between kernels (< 50 us)"] += s
            continue
        mid = (a + b) // 2
        inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = max(inner)[2] if inner else "outside spans"
        i = bisect.bisect_right(starts, mid) - 1
        op = "python, no op"
        for j in range(i, max(i - _LOOK_BACK, -1), -1):
            if cpu[j][1] >= mid:
                op = cpu[j][2]
                break
        idle[f"{label} / {op}"] += s
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "group_s": dict(group_s), "idle_s": dict(idle)}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
