"""Captured CUDA graphs of the serving loops' steps.

The counterpart of the JAX package's jitted serving loops
(``Engine._decode_n_impl``'s ``lax.scan``, ``decode_chunk``, the jitted
slot prefills and the speculative ``lax.while_loop``): on the card, each
step body is captured once into a ``torch.cuda.CUDAGraph`` and the host
only replays it; a loop of steps is a loop of replays with no host work
between them.  Elsewhere (``device="cpu"``, the tests) and on the card's
eager loop (``graphs=False``) the same body runs as one eager call per
step.

A body reads and writes only tensors of fixed address (the engine's
static cache and the buffers of :meth:`GraphRunner.buffers`); it computes
everything else on the device, so a replay needs no host input.  A graph
holds the model and cache it was captured on (``binds``): a later call
of the same key with others raises instead of replaying on the old ones.

:class:`GraphRunner` keys each graph on what routing reads at capture
time: the caller's key (step kind, batch, S or bucket, window, compute
dtype, ``use_kernels``) and the decode switches as set now
(``models.stacked.routing_key``), which ``decode_switches`` toggles
inside one process.

Spans (``utils.profiling.TRACER``, while a profiler runs): each replay,
and each eager run of a body, is a ``serve.launch`` span.  Captures are
counted in ``captures`` and timed in ``capture_s`` (``stats()``).

Launch counters: the warm-up and the capture run the wrappers (which
count) but launch nothing that stays (the warm-up's writes are undone,
the capture only records); the runner takes their counts back and adds
the step's launches on every replay (``ops.add_launch_counts``).
"""

from __future__ import annotations

import time
import types
from typing import Callable, Dict, Sequence, Tuple

import torch

from .. import ops
from ..models.stacked import routing_key
from ..utils.profiling import TRACER


class GraphRunner:
    """One engine's captured steps: graphs keyed by what routing reads,
    one memory pool for them all, static buffers, and the counts
    ``captures``, ``replays``, ``capture_s``, ``pool_bytes`` and
    ``reserved_bytes`` (the growth of ``torch.cuda.memory_allocated`` and
    of ``memory_reserved`` over the captures).

    ``graphed`` is true on a CUDA device unless ``enabled`` is false;
    otherwise :meth:`run` calls the body."""

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.graphed = enabled and self.device.type == "cuda"
        self._graphs: Dict[tuple, tuple] = {}
        self._buffers: Dict[tuple, types.SimpleNamespace] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.reserved_bytes = 0

    def buffers(self, key, **specs) -> types.SimpleNamespace:
        """Zeroed static tensors ``name=(shape, dtype)``, made once per
        ``key`` (outside inference mode, so in-place updates are allowed
        in and out of it)."""
        buf = self._buffers.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = types.SimpleNamespace(**{
                    name: torch.zeros(shape, dtype=dtype, device=self.device)
                    for name, (shape, dtype) in specs.items()})
            self._buffers[key] = buf
        return buf

    def run(self, key: tuple, body: Callable[[], None],
            state: Sequence[torch.Tensor] = (), times: int = 1,
            binds: Sequence[object] = ()) -> None:
        """Run ``body()`` ``times`` times: eagerly, or as replays of its
        graph for ``key`` (captured at the first call).  ``state`` lists
        every small tensor the body advances (lengths, tokens, counters):
        the warm-up restores them, so the first replay sees what the
        caller gave.  ``binds`` lists the objects the body reaches by
        address (the model, the caches): the graph replays only on the
        ones it was captured on, and other ones raise ``ValueError``."""
        if times == 0:
            return
        if not self.graphed:
            for _ in range(times):
                with TRACER.span("serve.launch"):
                    body()
            return
        full = tuple(key) + routing_key()
        entry = self._graphs.get(full)
        if entry is None:
            entry = self._graphs[full] = (self._capture(full, body, state)
                                          + (tuple(binds),))
        graph, delta, bound = entry
        if len(bound) != len(binds) or any(
                a is not b for a, b in zip(bound, binds)):
            raise ValueError(f"the graph of {key} replays on the model and "
                             "caches it was captured on, not on others")
        # one span a replay: the first one's end is when the device has
        # work again
        for _ in range(times):
            with TRACER.span("serve.launch"):
                graph.replay()
        ops.add_launch_counts(delta, times)
        self.replays += times

    def _capture(self, key, body, state):
        t0 = time.perf_counter()
        mem0 = self._memory()
        saved = [t.clone() for t in state]
        c0 = ops.counter_state()
        self._warm_up(body)
        for t, s in zip(state, saved):
            t.copy_(s)
        c1 = ops.counter_state()
        try:
            graph = self._record(body)
        except Exception as exc:
            ops.add_launch_counts(ops.count_delta(c0, ops.counter_state()))
            raise RuntimeError(f"CUDA graph capture of {key} failed; the "
                               "card has no eager fallback") from exc
        c2 = ops.counter_state()
        warm, delta = ops.count_delta(c1, c0), ops.count_delta(c2, c1)
        ops.add_launch_counts(ops.count_delta(c0, c2))
        if warm != delta:
            raise RuntimeError(f"{key}: the warm-up launched {warm}, the "
                               f"capture {delta}")
        del saved
        mem1 = self._memory()
        self.pool_bytes += mem1[0] - mem0[0]
        self.reserved_bytes += mem1[1] - mem0[1]
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, delta

    # -- the card's side of a capture --------------------------------------

    def _memory(self) -> Tuple[int, int]:
        """(allocated, reserved) device bytes once the queue is done."""
        torch.cuda.synchronize(self.device)
        return (torch.cuda.memory_allocated(self.device),
                torch.cuda.memory_reserved(self.device))

    def _warm_up(self, body) -> None:
        """``body()`` on a side stream, as capture requires: lazy builds,
        library handles and first-call set-up happen here."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body()
        current.wait_stream(side)

    def _record(self, body) -> "torch.cuda.CUDAGraph":
        """``body()`` captured into a graph in the engine's pool (nothing
        runs)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            body()
        return graph

    def stats(self) -> dict:
        return dict(captures=self.captures, replays=self.replays,
                    capture_s=self.capture_s,
                    pool_mb=self.pool_bytes / 2**20,
                    reserved_mb=self.reserved_bytes / 2**20)
