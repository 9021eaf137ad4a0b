"""AMQ's search evaluation: ``Evaluator.eval_many`` over architectures
drawn from the seed.

Set-up: a dense bf16 model from the seed (``perfbench.model.build_dense``)
and, one width at a time, its round-to-nearest proxies at each of
``bits`` (``model.proxy``), handed to ``Evaluator(search=True,
proxies=...)``, which computes the dense logits of the configuration's
``n_sample`` token rows of ``seqlen`` tokens (uniform over the vocab,
from the seed) and stacks the proxies; then one ``eval_many`` call of its own architectures, so
every kernel, library handle and allocation is warm.  The window opens
there: each ``eval_many`` call evaluates ``archs_per_call`` fresh
architectures (every linear of every layer at a width drawn from the
seed) and is one span; the window ends at the end of the first call that
ends ``seconds`` after it opened, so only whole evaluations count.

Correctness: once the window has closed and the peak memory is read, the
evaluator is freed, and ``perfbench.reference`` recomputes one
architecture evaluated in the window (drawn from the seed): the dense
model's float32 logits, the student's from its own round-to-nearest
quantization of the dense weights (``reference/quant.py``), and the mean
JSD over the samples.  The gap between
the program's loss and the reference's, as a share of the reference's,
is held to the cell's limit.  With ``control`` (calibration only) the
control's loss (the reference with every linear in float8 e4m3) takes
the program's place in that comparison, so ``correct`` reads false;
``program_checks`` then holds the program's own reading.
"""

from __future__ import annotations

import gc
import math
import time
import types

import numpy as np
import torch

from perfbench import model, trace
from perfbench.reference import jsd, llama as reference
from perfbench.reference.quant import rtn_weight


def _arch(rng, bits, layers) -> dict:
    return {"linear": {n: [int(b) for b in rng.choice(bits, layers)]
                       for n in model.LINEARS}}


def reference_loss(params, shape, quant, arch, tokens, control=False):
    """The reference's mean JSD of ``arch``'s student against the dense
    model over the token rows ``tokens`` ``[n, S]`` (the control: every
    linear of both in float8 e4m3)."""
    mm = reference.fp8_mm if control else reference.plain_mm
    group = quant["group_size"]
    seqs = list(tokens)
    dense = reference.Dense(params)

    def student_linears(i):
        lay = params["layers"][i]
        return {n: rtn_weight(lay[n].weight, arch["linear"][n][i], group)
                for n in model.LINEARS}

    student = reference.Dense(params, linears=student_linears)
    xd = reference.final_states(dense, shape, seqs, mm)
    xs = reference.final_states(student, shape, seqs, mm)
    head = dense.head()
    losses = [jsd.sample_jsd(reference.logits(s, head, mm),
                             reference.logits(d, head, mm))
              for s, d in zip(xs, xd)]
    return sum(losses) / len(losses)


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False):
    """One run of a ``search_eval`` cell; returns the record the metrics
    read (a namespace)."""
    from amq_tpu_torch.evaluation.evaluator import Evaluator
    from amq_tpu_torch.models.config import get_config
    conf, tr = cell["config_data"], cell["traffic_data"]
    shape, quant = conf["shape"], conf["quant"]
    cfg = get_config(conf["registry_name"])
    device = torch.device(device)
    dtype = getattr(torch, quant["compute_dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.build_dense(shape, quant, gen, device)
    rng = np.random.default_rng([seed, 1])
    V, L = shape["vocab_size"], shape["num_hidden_layers"]
    n_sample = conf["n_sample"]
    tokens = rng.integers(0, V, (n_sample, tr["seqlen"])).astype(np.int32)
    bits, group = tr["bits"], quant["group_size"]
    ev = Evaluator(cfg, params,
                   proxies=[lambda b=b: model.proxy(params, b, group)
                            for b in bits],
                   bits_range=bits, datasets={"synthetic": tokens},
                   group_size=group, batch_size=tr["batch_size"],
                   compute_dtype=dtype, device=device, search=True)
    k = tr["archs_per_call"]
    ev.eval_many([_arch(rng, bits, L) for _ in range(k)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    traced_slice = trace.Slice(traced, tr["trace_seconds"], seconds)
    setup_s = time.perf_counter() - t_start

    calls = []
    t_open = time.perf_counter()
    while True:
        archs = [_arch(rng, bits, L) for _ in range(k)]
        active = traced_slice.active
        with trace.span("eval_many"):
            out = ev.eval_many(archs)
        t1 = time.perf_counter()
        calls.append(dict(t1=t1, archs=archs,
                          losses=[o[0]["synthetic"] for o in out],
                          traced=active))
        if t1 - t_open >= seconds:
            break
        traced_slice.step_ended(t1 - t_open)
    traced_slice.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    losses = [x for c in calls for x in c["losses"]]
    failed = sum(not math.isfinite(x) for x in losses)
    check_rng = np.random.default_rng([seed, 2])
    pick = int(check_rng.integers(len(losses)))
    arch = [a for c in calls for a in c["archs"]][pick]
    del ev
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    toks = torch.as_tensor(tokens, device=device)
    ref = reference_loss(params, shape, quant, arch, toks)
    limit = cell["checks"]["loss_rel_gap"]

    def checks_of(loss):
        return {"loss_rel_gap": {"value": abs(loss - ref) / ref,
                                 "limit": limit}}

    checks = checks_of(reference_loss(params, shape, quant, arch, toks, True)
                       if control else losses[pick])
    return types.SimpleNamespace(
        cell=cell, shape=shape, quant=quant, traffic=tr, n_sample=n_sample,
        correct=checks["loss_rel_gap"]["value"] <= limit and not failed,
        attempted=len(losses), failed=failed, checks=checks,
        program_checks=checks_of(losses[pick]) if control else checks,
        setup_s=setup_s, window_s=calls[-1]["t1"] - t_open, calls=calls,
        memory_peak_bytes=peak, trace=traced_slice.summary(cell["root"]))
