"""Tracing / profiling utilities.

:class:`Tracer` records nested wall-clock spans (the JAX package's
``Tracer``, same API: ``span``, ``summary``, ``dump``) and keeps their
totals.  With ``keep_spans`` it also keeps each span: its name, its
start and end on ``time.perf_counter_ns``, the span it ran inside, an
optional request id (spans of one request share it) and, when asked,
the rise of the kernel launch counters over it (``ops.counter_state``:
launches stay counted in ``ops``, once).  It also keeps counters
(``count``).  While a ``torch.profiler`` profile runs,
each span is also a ``record_function("amq.<name>")`` range, so it lands
in the device trace on the profiler's clock, nested in the caller's.

:data:`TRACER` is the program's one tracer: the serving loop and the
evaluator record into it.  It records only while a ``torch.profiler``
profile runs (``torch.autograd.profiler._is_profiler_enabled``); with no
profiler running a span reads that flag and returns a shared no-op
context (no clock, no ``record_function``, no allocation), and a count
reads the flag and adds nothing.  A request admitted while no profiler
runs drops the queued span it began in an earlier session; one still
queued when a session ends carries its submission time into the next
session unless ``reset()`` runs between them.

:func:`device_trace` is a ``torch.profiler`` capture of CPU and CUDA
activity written as a Chrome trace, for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_now = time.perf_counter_ns


@dataclasses.dataclass
class Span:
    """One recorded span.  ``parent`` is the index in the tracer's
    ``spans`` of the span it ran inside (None at the top); ``launches``
    the rise of the launch counters over it, ``{"<wrapper>.<counter>":
    n}``, when the span asked for it."""
    name: str
    start_ns: int
    end_ns: int = -1
    parent: Optional[int] = None
    uid: Optional[int] = None
    launches: Optional[Dict[str, int]] = None


def _launch_state() -> dict:
    # imported when first asked: a tracer alone needs none of the kernels
    from .. import ops
    return ops.counter_state()


def _launch_rise(before: dict) -> Dict[str, int]:
    from .. import ops
    return {f"{fn.__name__}.{attr}": n for (fn, attr), n in
            ops.count_delta(ops.counter_state(), before).items()}


class _Off:
    """The context of a span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    """The context of a span being recorded."""
    __slots__ = ("tracer", "name", "uid", "launches", "rec", "rf", "before")

    def __init__(self, tracer: "Tracer", name: str, uid, launches: bool):
        self.tracer, self.name, self.uid = tracer, name, uid
        self.launches = launches

    def __enter__(self) -> Span:
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(f"amq.{self.name}")
            self.rf.__enter__()
        self.before = _launch_state() if self.launches else None
        self.rec = self.tracer._begin(self.name, self.uid)
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        self.tracer._end(rec)
        if self.before is not None:
            rec.launches = _launch_rise(self.before)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """Span and counter recorder: ``with tracer.span('eval'): ...``.
    One thread records into one tracer.  ``keep_spans``: keep every span
    in ``spans``, not only the totals by name."""

    def __init__(self, keep_spans: bool = False):
        self.keep_spans = keep_spans
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter."""
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        #: the spans kept since the last reset, in the order they began
        #: (a :meth:`begin` span in the order it ended), and the counters
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._stack: List[int] = []
        self._waiting: Dict[Tuple[str, object], Span] = {}

    @property
    def on(self) -> bool:
        """Whether spans and counts are recorded now."""
        return True

    def span(self, name: str, uid=None, launches: bool = False):
        """A context that records the span ``name`` (request id ``uid``;
        with ``launches``, the launch counters' rise over it)."""
        return _Recording(self, name, uid, launches)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def begin(self, name: str, uid) -> None:
        """Open the span ``name`` of request ``uid`` that :meth:`end`
        closes, in another call (a request's wait in a queue).  It has no
        parent and no ``record_function`` range, which would not nest."""
        self._waiting[(name, uid)] = Span(name, _now(), uid=uid)

    def end(self, name: str, uid) -> None:
        """Close the span :meth:`begin` opened, if it did."""
        rec = self._waiting.pop((name, uid), None)
        if rec is not None:
            rec.end_ns = _now()
            if self.keep_spans:
                self.spans.append(rec)
            self._total(rec)

    def _begin(self, name: str, uid) -> Span:
        rec = Span(name, _now(), uid=uid)
        if self.keep_spans:
            rec.parent = self._stack[-1] if self._stack else None
            self._stack.append(len(self.spans))
            self.spans.append(rec)
        return rec

    def _end(self, rec: Span) -> None:
        rec.end_ns = _now()
        if self.keep_spans:
            self._stack.pop()
        self._total(rec)

    def _total(self, rec: Span) -> None:
        self.totals[rec.name] += (rec.end_ns - rec.start_ns) / 1e9
        self.counts[rec.name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": self.totals[k] / self.counts[k] * 1e3}
            for k in sorted(self.totals)
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


class ProfilerTracer(Tracer):
    """A :class:`Tracer` that keeps every span, and records only while a
    ``torch.profiler`` profile runs."""

    def __init__(self):
        super().__init__(keep_spans=True)

    @property
    def on(self) -> bool:
        return _autograd_profiler._is_profiler_enabled

    def span(self, name: str, uid=None, launches: bool = False):
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Recording(self, name, uid, launches)

    def count(self, name: str, n: int = 1) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self.counters[name] += n

    def begin(self, name: str, uid) -> None:
        if _autograd_profiler._is_profiler_enabled:
            super().begin(name, uid)

    def end(self, name: str, uid) -> None:
        if _autograd_profiler._is_profiler_enabled:
            super().end(name, uid)
        elif self._waiting:
            # begun in a session that has ended
            self._waiting.pop((name, uid), None)


#: the program's tracer (serving loop, graphs, evaluator)
TRACER = ProfilerTracer()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """``torch.profiler`` capture of CPU and CUDA activity over the block,
    written to ``logdir/trace.json`` (Chrome trace format); a no-op when
    ``logdir`` is falsy.  A profiler that fails to start or stop raises:
    a trace that silently is not taken would be read as an empty one."""
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
