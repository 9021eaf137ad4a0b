"""``closed_chat``'s loop on a sparse (Qwen2-MoE) model.

The same clients, size schedule, batcher, window and check: a fresh copy
of ``loops/closed_chat.py`` is loaded and run with three of its names
bound anew, so nothing of the loop is written twice:

* ``model`` -> ``perfbench.model_moe`` (random packed weights with the
  routed experts, the shared expert, router and gate),
* ``reference`` -> ``perfbench.reference.moe`` (the sparse block's plain
  float32 forward and the same logit gaps), judging by the mean gap of
  the served tokens: the loop holds it to the cell's
  ``checks.mean_logit_gap`` and reports it under that name (the widest
  gap, set by one token's k-th / (k+1)-th expert choice, is printed to
  standard error beside it),
* ``trace`` -> ``perfbench.trace`` with a slice that also reads the
  port's device counters of the expert products (``ops.moe``) when it
  opens and when it closes: its summary carries their rise over the
  slice under ``"moe"`` (per form, the experts hit, per layer too, the
  pairs and the experts offered), which ``metrics/expert_roofline.serve``
  reads, and the rise goes into the program's tracer
  (``ops.moe.fold_counters``).  Reading them syncs the card twice a
  traced run, outside the slice.

The expert kernels' library is built in set-up (``run.py`` builds the
dense paths' only).
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import torch

from perfbench import bench, model_moe, trace
from perfbench.reference import moe as reference


class _CountedSlice(trace.Slice):
    """``trace.Slice`` reading the device counters around the slice."""

    device = None

    def _counters(self):
        from amq_tpu_torch.ops import moe
        return moe.device_counters(self.device).cpu()

    def step_ended(self, elapsed: float) -> None:
        if (self.trace is not None and not self.active
                and self.trace.events is None and elapsed >= self.opens_at):
            self.before = self._counters()
        super().step_ended(elapsed)

    def close(self) -> None:
        was = self.active
        super().close()
        if was:
            from amq_tpu_torch.ops import moe
            from amq_tpu_torch.utils.profiling import TRACER
            self.after = self._counters()
            moe.fold_counters(TRACER, self.before, self.after)

    def summary(self, root):
        out = super().summary(root)
        if out is not None and hasattr(self, "after"):
            from amq_tpu_torch.ops import moe
            out["moe"] = moe.counter_rise(self.before, self.after)
        return out


def _judge_by_mean(weights, shape, requests, control=False):
    """``reference.judge`` with its mean gap where ``closed_chat`` holds
    the gap to the cell's limit."""
    j = reference.judge(weights, shape, requests, control=control)
    print(f"reference: {'control' if control else 'program'} mean gap "
          f"{j['mean_logit_gap']} widest {j['logit_gap']} over "
          f"{j['tokens']} tokens", file=sys.stderr, flush=True)
    return {"logit_gap": j["mean_logit_gap"], "tokens": j["tokens"]}


def _renamed(checks: dict) -> dict:
    return {("mean_logit_gap" if k == "logit_gap" else k): v
            for k, v in checks.items()}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False):
    """One run of a ``closed_chat_moe`` cell (``closed_chat.run``'s record,
    its checks under ``mean_logit_gap``)."""
    from amq_tpu_torch.models.config import get_config
    get_config(cell["config_data"]["registry_name"])   # a known model first
    device = torch.device(device)
    if device.type == "cuda":
        from amq_tpu_torch.ops import _cuda
        _cuda.build(("moe_experts",))
    chat = bench.module(Path(cell["root"]), "loops", "closed_chat")
    slice_cls = type("Slice", (_CountedSlice,), {"device": device})
    chat.model = model_moe
    chat.reference = types.SimpleNamespace(judge=_judge_by_mean)
    chat.trace = types.SimpleNamespace(span=trace.span, Slice=slice_cls)
    inner = dict(cell, checks={"logit_gap": cell["checks"]["mean_logit_gap"]})
    out = chat.run(inner, seed, seconds, traced, device, t_start,
                   control=control)
    out.cell = cell
    out.checks = _renamed(out.checks)
    out.program_checks = _renamed(out.program_checks)
    return out
