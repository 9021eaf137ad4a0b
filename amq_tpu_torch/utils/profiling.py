"""Tracing / profiling utilities.

A nestable wall-clock span recorder (the JAX package's ``Tracer``, same
API) plus a ``torch.profiler`` capture of CPU and CUDA activity written as
a Chrome trace, for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile


class Tracer:
    """Lightweight span recorder: ``with tracer.span('eval'): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": self.totals[k] / self.counts[k] * 1e3}
            for k in sorted(self.totals)
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


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
