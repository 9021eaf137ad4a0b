"""Launch SPMD ranks, and the parallel forms' rank programs.

:func:`spawn` starts ``n`` fresh processes (``torch.multiprocessing``'s
spawn context) joined in one process group through a file store in a new
temporary directory (no fixed TCP port, so concurrent launches on one host
never collide), runs ``fn(rank, n, *args)`` in each and returns every
rank's result.  On a machine with cards, rank ``r`` takes card
``r % device_count`` (several ranks share one card when there are more
ranks than cards).

The ``*_run`` functions are rank programs of the five parallel modes: the
tensor-parallel unrolled model (``tp``), pipeline stages (``pp``), the
tensor-parallel stacked serving model (``tp-stacked``, with a data axis),
stages of tensor-parallel shards (``pp-tp``) and data-parallel slots
(``dp-serving``); ``dp_eval_run`` is data-parallel evaluation.  They
return numpy arrays and Python values.  Like the port's engines they run
on the rank's card with the kernels unless the caller passes
``device="cpu"`` (and, for the plain path, ``use_kernels=False``); without
a card and without that request they raise.

    python -m amq_tpu_torch.parallel.launch --nprocs 4 --device cpu

runs the five modes on a small random model against one process (the
counterpart of the JAX package's multi-device dry run), printing one
``dryrun <mode> ok`` line each.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
import traceback
from multiprocessing import connection as mp_connection
from multiprocessing import resource_tracker
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device


# ---------------------------------------------------------------------------
# spawning

def _stop_resource_tracker() -> None:
    """Stop the resource tracker that starting a spawn-context process
    launches: a helper process that otherwise outlives every rank and
    exits only after this process does.  Only for a tracker that
    :func:`spawn` started itself: the ranks report over pipes, which
    register nothing with it."""
    resource_tracker._resource_tracker._stop()


def _rank_main(fn, rank, world, backend, init_method, args, kwargs, threads,
               conn):
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend=backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            result = fn(rank, world, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        conn.send((True, pickle.dumps(result)))
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def spawn(fn: Callable, nprocs: int, *args, backend: str,
          timeout: float = 600.0, threads: Optional[int] = None,
          **kwargs) -> List[Any]:
    """``[fn(r, nprocs, *args, **kwargs) for r in range(nprocs)]``, each
    in its own process, joined in a ``backend`` group ("gloo" or "nccl",
    named by the caller).  ``fn`` must be importable (module level); its
    result is pickled by value.  A rank that raises, dies or outlives
    ``timeout`` seconds makes this raise (every rank is then stopped).
    ``threads`` sets each rank's intra-op thread count."""
    ctx = torch.multiprocessing.get_context("spawn")
    tracker_was_running = resource_tracker._resource_tracker._fd is not None
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        pipes = [ctx.Pipe(duplex=False) for _ in range(nprocs)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, backend, init, args,
                                   kwargs, threads, pipes[r][1]))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        for _, send in pipes:
            send.close()
        waiting = {pipes[r][0]: r for r in range(nprocs)}
        deadline = time.monotonic() + timeout
        try:
            while waiting and not errors:
                for conn in mp_connection.wait(list(waiting), timeout=0.5):
                    rank = waiting.pop(conn)
                    try:
                        ok, payload = conn.recv()
                    except EOFError:
                        procs[rank].join(timeout=5)
                        errors[rank] = (f"exited without a result (exit code "
                                        f"{procs[rank].exitcode})")
                        continue
                    if ok:
                        results[rank] = pickle.loads(payload)
                    else:
                        errors[rank] = payload
                if waiting and time.monotonic() > deadline:
                    raise RuntimeError(f"spawn of {fn.__name__}: timed out "
                                       f"after {timeout} s; errors {errors}")
        finally:
            if errors or len(results) < nprocs:
                for p in procs:
                    if p.is_alive():
                        p.kill()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
            for recv, _ in pipes:
                recv.close()
            if not tracker_was_running:
                _stop_resource_tracker()
    if errors:
        raise RuntimeError(f"spawn of {fn.__name__} failed:\n"
                           + "\n".join(f"rank {r}:\n{e}"
                                       for r, e in sorted(errors.items())))
    return [results[r] for r in range(nprocs)]


def descendants(pid: Optional[int] = None) -> List[Tuple[int, str]]:
    """The live processes below ``pid`` (default this process), children
    and theirs, as ``(pid, command line)`` read from ``/proc``; exited
    ones not yet reaped are left out."""
    root = os.getpid() if pid is None else pid
    parent, cmd = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:                          # exited while we looked
            continue
        if fields[0] != "Z":
            parent[int(d)], cmd[int(d)] = int(fields[1]), line.strip()
    found, frontier = [], [root]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        found += kids
        frontier = kids
    return [(p, cmd[p]) for p in sorted(found)]


# ---------------------------------------------------------------------------
# rank programs

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def tp_stacked_run(rank, world, proxies, bits_range, cfg, tokens, *,
                   steps=0, tp=None, stack_kw=None,
                   compute_dtype=torch.float32, max_len=32, device=None,
                   use_kernels=True):
    """Prefill ``tokens`` [B, S] and ``steps`` greedy decode steps through
    the TP stacked forward: ``tp`` ranks per 'tensor' row (default all),
    the batch rows split over the 'data' rows; ``use_kernels`` routes the
    linears and decode attention through the kernels.  Returns ``(data
    index, tensor index, [logits of each call])`` for this rank's rows."""
    device = resolve_device(device)
    from ..models import linear as linear_mod
    from ..models import llama
    from ..serving.engine import kernel_linear_impl
    from . import multihost, tp_stacked as tps
    tp = tp or world
    mesh = multihost.pod_mesh(tensor_per_host=tp)
    model = tps.stack_proxies_tp(proxies, bits_range, cfg, tp,
                                 mesh.tensor_index, **(stack_kw or {}))
    rows = np.array_split(np.arange(len(tokens)), mesh.shape["data"])
    toks = torch.as_tensor(np.asarray(tokens)[rows[mesh.data_index]],
                           dtype=torch.int64, device=device)
    fwd = tps.make_tp_forward_stacked(cfg, mesh.tensor_group, tp,
                                      compute_dtype)
    cache = tps.new_tp_cache(cfg, tp, toks.shape[0], max_len,
                             dtype=compute_dtype, device=device)
    outs = []
    impl = kernel_linear_impl if use_kernels else None
    with torch.inference_mode(), linear_mod.kernel_linears(impl), \
            llama.forward_kernels(use_kernels):
        logits, cache = fwd(model, toks, cache)
        outs.append(_np(logits))
        for _ in range(steps):
            nxt = torch.argmax(logits[:, -1], dim=-1)
            logits, cache = fwd(model, nxt[:, None], cache)
            outs.append(_np(logits))
    return mesh.data_index, mesh.tensor_index, outs


def tp_run(rank, world, params, cfg, tokens, step_tokens=(), *,
           compute_dtype=torch.float32, max_len=32, device=None):
    """The TP unrolled forward over ``params`` (``init_params``-shaped):
    prefill ``tokens`` with a cache, then one call per ``step_tokens``
    entry [B, 1].  Returns the logits of each call."""
    device = resolve_device(device)
    from ..models import llama
    from . import tp as tpmod
    shard = tpmod.shard_params(params, world, rank)
    fwd = tpmod.make_tp_forward(cfg, dist.group.WORLD, world, compute_dtype)
    B = np.asarray(tokens).shape[0]
    cache = llama.KVCache.create(tpmod.local_config(cfg, world), B, max_len,
                                 dtype=compute_dtype, device=device)
    outs = []
    with torch.inference_mode():
        for t in [tokens, *step_tokens]:
            t = torch.as_tensor(np.asarray(t), dtype=torch.int64,
                                device=device)
            logits, cache = fwd(shard, t, cache)
            outs.append(_np(logits))
    return outs


def pp_run(rank, world, model_or_proxies, cfg, prompt, step_tokens=(), *,
           n_micro=2, tp=1, bits_range=None, arch=None,
           compute_dtype=torch.float32, max_len=32, device=None,
           use_kernels=True):
    """A pipeline over ``world / tp`` stages: prefill ``prompt`` [B, S],
    then one decode call per ``step_tokens`` entry [B, 1].  With ``tp > 1``
    ``model_or_proxies`` are the per-bit proxies (each stage a TP group of
    ``parallel.tp_stacked`` shards), else the stacked model.  Returns the
    last-position logits of each call."""
    device = resolve_device(device)
    from . import pp, tp_stacked as tps
    n_stages = world // tp
    mesh = pp.stage_mesh(n_stages, tp)
    if tp > 1:
        model = tps.stack_proxies_tp(model_or_proxies, bits_range, cfg, tp,
                                     mesh.tensor_index, arch=arch)
        scan_cfg = tps.local_stacked_config(cfg, tp)
    else:
        model, scan_cfg = model_or_proxies, cfg
    stage = pp.shard_model_pp(model, n_stages, mesh.data_index)
    B = np.asarray(prompt).shape[0]
    caches = pp.new_pp_cache(scan_cfg, stage.num_layers, B, n_micro, max_len,
                             dtype=compute_dtype, device=device)
    step = pp.make_pp_step(cfg, mesh, stage, n_micro,
                           compute_dtype=compute_dtype,
                           use_kernels=use_kernels)
    return [_np(step(stage, torch.as_tensor(np.asarray(t), dtype=torch.int64,
                                            device=device), caches))
            for t in [prompt, *step_tokens]]


def dp_serving_run(rank, world, model, cfg, prompts, n_new, *,
                   slots_per_rank=1, chunk_steps=1, prefill_buckets=(8, 16),
                   compute_dtype=torch.float32, max_len=64, device=None,
                   use_kernels=True):
    """Data-parallel slots: every rank submits the same requests and runs
    the same loop.  Returns ``{uid: tokens}`` as this rank saw it."""
    device = resolve_device(device)
    from ..serving.dp import DPSlotEngine
    from ..serving.engine import ContinuousBatcher, Request
    eng = DPSlotEngine(model, cfg, dist.group.WORLD,
                       slots_per_rank=slots_per_rank, max_len=max_len,
                       compute_dtype=compute_dtype, use_kernels=use_kernels,
                       prefill_buckets=prefill_buckets,
                       chunk_steps=chunk_steps, device=device)
    batcher = ContinuousBatcher(n_slots=eng.n_slots, max_len=max_len)
    for i, p in enumerate(prompts):
        batcher.submit(Request(uid=i, prompt=np.asarray(p, np.int32),
                               max_new_tokens=n_new))
    return eng.run(batcher)


def hqq_realize(params, cfg, arch, method="hqq"):
    """The final-mode evaluator's ``quantize_fn`` for an HQQ realization."""
    from ..quantization.api import get_quantized_params
    return get_quantized_params(params, cfg, method, arch)


def dp_eval_run(rank, world, cfg, dense_params, datasets, archs, *,
                batch_size=2, search=True, compute_dtype=torch.float32,
                device=None):
    """Data-parallel evaluation: an ``Evaluator`` whose samples are split
    over the group's ranks (final mode: HQQ realizations).  Returns
    ``eval(arch)`` for each arch."""
    device = resolve_device(device)
    from ..evaluation.evaluator import Evaluator
    ev = Evaluator(cfg, dense_params=dense_params, datasets=datasets,
                   batch_size=batch_size, compute_dtype=compute_dtype,
                   device=device, search=search,
                   quantize_fn=None if search else hqq_realize,
                   data_group=dist.group.WORLD)
    return [ev.eval(a) for a in archs]


def cli_run(rank, world, module, argv):
    """``main(argv)`` of ``amq_tpu_torch.cli.<module>`` on every rank (a
    data-parallel run passes ``--data_parallel``).  Returns its result."""
    import importlib
    return importlib.import_module(f"amq_tpu_torch.cli.{module}").main(argv)


# ---------------------------------------------------------------------------
# the five-mode dry run

def _tiny(device, seed=0):
    """A small random model (``graft-tp``: every TP cut group-aligned up to
    tp 4), its 2/3/4-bit proxies and a cycled arch."""
    from ..models.config import LINEAR_NAMES, get_config
    from ..models.llama import init_params
    from ..models.transform import quantize_model
    cfg = get_config("graft-tp")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    bits = (2, 3, 4)
    proxies = [quantize_model(params, cfg, b, optimize=False) for b in bits]
    arch = {"linear": {n: [bits[i % 3] for i in range(cfg.num_layers)]
                       for n in LINEAR_NAMES}}
    return cfg, params, proxies, bits, arch


def _close(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))
    if not (got.shape == want.shape and err <= tol):
        raise AssertionError(f"{got.shape} vs {want.shape}: rel err {err}")
    return err


def dryrun(nprocs: int = 4, device: str = "cpu", backend: str = "gloo"):
    """The five modes on ``nprocs`` ranks against one process, float32."""
    from ..models import llama
    from ..models.stacked import forward_stacked, stack_proxies
    from ..serving.batched import SlotEngine
    from ..serving.engine import ContinuousBatcher, Request
    f32 = torch.float32
    cfg, params, proxies, bits, arch = _tiny(device)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int64)
    steps = rng.integers(0, cfg.vocab_size, (2, 4, 1)).astype(np.int64)
    tp = 2 if nprocs % 2 == 0 else 1
    # one intra-op thread a rank on the CPU: the ranks share its cores;
    # the rank programs on the plain path, as the references run
    kw = dict(backend=backend, threads=1 if device == "cpu" else None)
    plain = dict(device=device, use_kernels=False)

    def ref_chain(model, fwd, n):
        cache = llama.KVCache.create(cfg, 4, 32, dtype=f32, device=device)
        outs = []
        with torch.inference_mode():
            for t in [toks, *steps[:n]]:
                logits, cache = fwd(model, torch.as_tensor(t, device=device),
                                    cache)
                outs.append(_np(logits))
        return outs

    # tp: the unrolled model, every rank a shard (row-parallel K cut at
    # whole packing blocks: 128-row superblocks)
    from ..models.transform import quantize_model
    q3 = quantize_model(params, cfg, 3, optimize=False, superblock=128)
    got = spawn(tp_run, nprocs, q3, cfg, toks, steps, device=device, **kw)[0]
    want = ref_chain(q3, lambda m, t, c: llama.forward(
        m, cfg, t, cache=c, compute_dtype=f32), 2)
    err = max(_close(g, w) for g, w in zip(got, want))
    print(f"dryrun tp ok: tensor={nprocs} rel_err={err:.2e}", flush=True)

    stacked = stack_proxies(proxies, bits, arch=arch)
    want = ref_chain(stacked, lambda m, t, c: forward_stacked(
        m, cfg, t, cache=c, compute_dtype=f32), 2)
    # pp: stages of the stacked model
    got = spawn(pp_run, nprocs, stacked, cfg, toks, steps, n_micro=2,
                **plain, **kw)[0]
    err = max(_close(g, w[:, -1]) for g, w in zip(got, want))
    print(f"dryrun pp ok: stages={nprocs} rel_err={err:.2e}", flush=True)

    # tp-stacked: (data x tensor), batch rows over 'data'
    res = spawn(tp_stacked_run, nprocs, proxies, bits, cfg, toks, steps=2,
                tp=tp, stack_kw=dict(arch=arch, head_bits=None),
                **plain, **kw)
    rows = {d: outs for d, t, outs in res if t == 0}
    got = [np.concatenate([rows[d][i] for d in sorted(rows)])
           for i in range(3)]
    ref_steps = ref_chain(stacked, lambda m, t, c: forward_stacked(
        m, cfg, t, cache=c, compute_dtype=f32), 0)
    err = _close(got[0], ref_steps[0])
    print(f"dryrun tp-stacked ok: data={nprocs // tp} tensor={tp} "
          f"rel_err={err:.2e}", flush=True)

    # pp-tp: stages of tensor-parallel shards
    if nprocs >= 4 and tp == 2:
        got = spawn(pp_run, nprocs, proxies, cfg, toks, steps, n_micro=2,
                    tp=2, bits_range=bits, arch=arch, **plain, **kw)[0]
        err = max(_close(g, w[:, -1], 3e-4) for g, w in zip(got, want))
        print(f"dryrun pp-tp ok: stages={nprocs // 2} tensor=2 "
              f"rel_err={err:.2e}", flush=True)

    # dp-serving: slots over ranks against one process
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 7, 4, 6)]
    got = spawn(dp_serving_run, nprocs, stacked, cfg, prompts, 4,
                **plain, **kw)
    local = SlotEngine(stacked, cfg, n_slots=2, max_len=64, compute_dtype=f32,
                       use_kernels=False, prefill_buckets=(8, 16),
                       device=device)
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    for i, p in enumerate(prompts):
        batcher.submit(Request(uid=i, prompt=np.asarray(p, np.int32),
                               max_new_tokens=4))
    want = local.run(batcher)
    if any(g != want for g in got):
        raise AssertionError(f"dp-serving: {got} != {want}")
    print(f"dryrun dp-serving ok: ranks={nprocs} reqs={len(want)}",
          flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nprocs", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (every rank on card rank %% count) or cpu")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = p.parse_args(argv)
    resolve_device(args.device)
    dryrun(args.nprocs, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
