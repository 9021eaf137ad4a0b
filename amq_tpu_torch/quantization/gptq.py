"""GPTQ: Hessian-guided greedy weight quantization, in PyTorch.

The port of the JAX package's ``quantization/gptq.py``, the same function:

* dead columns (``diag(H) == 0``) get a unit diagonal and zero weights,
* damping ``percdamp * mean(diag H)``, then ``Hinv = chol_upper(inv(H))``,
* column blocks of ``blocksize``; in a block, column by column: per-group
  min/max parameters refreshed on the *updated* weights at each group
  boundary, fake-quant, and the scaled error pushed into the block's
  remaining columns; after the block, its errors into the tail,
* optional activation ordering by descending ``diag(H)``.

Written in the upstream column-loop form (``fasterquant``): each column
updates a slice of the live block, where the JAX package's ``lax`` loops
apply a masked rank-1 update over the whole block; on the card a whole
block's column loop is one replayed CUDA graph (:func:`whole_block`).
Everything runs in float32 on the weight's device (TF32 off on the card:
``cli.common.setup_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.pseudo import find_params_minmax
from ..models import transform
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import DenseLinear
from . import calib
from .calib import StageClock, stage


def drop_dead_columns(W: torch.Tensor, H: torch.Tensor):
    """(W, H) in float32 with each dead column (``diag(H) == 0``) zeroed
    in W and given a unit diagonal in H."""
    Wf = W.float().clone()
    H = H.float().clone()
    dead = torch.diag(H) == 0
    H[dead, dead] = 1.0
    Wf[:, dead] = 0.0
    return Wf, H


def inverse_cholesky_upper(H: torch.Tensor, percdamp: float) -> torch.Tensor:
    """``chol_upper(inv(H + damp I))`` with ``damp = percdamp * mean(diag
    H)`` (the JAX package's ``cho_solve`` against the identity, then the
    upper factor of the inverse's transpose)."""
    cols = H.shape[0]
    eye = torch.eye(cols, dtype=torch.float32, device=H.device)
    damp = percdamp * torch.mean(torch.diag(H))
    L = torch.linalg.cholesky(H + damp * eye)
    Hinv_full = torch.cholesky_solve(eye, L)
    return torch.linalg.cholesky(Hinv_full.T).T


def column_loop(W1, Hinv1, scale, zero, maxq, Q1, Err1, Qi1=None,
                start: int = 0, stop: Optional[int] = None,
                n: Optional[int] = None) -> None:
    """Columns ``[start, stop)`` of one block, greedily, under fixed
    (scale, zero) ``[rows, 1]``, in place: each column's fake-quant into
    ``Q1`` (its codes into ``Qi1``), its scaled error into ``Err1`` and
    into the block's live columns ``[i, n)`` of ``W1``."""
    n = W1.shape[1] if n is None else n
    for i in range(start, n if stop is None else stop):
        w = W1[:, i:i + 1]
        qi = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
        q = scale * (qi - zero)
        err = (w - q) / Hinv1[i, i]
        Q1[:, i:i + 1] = q
        if Qi1 is not None:
            Qi1[:, i:i + 1] = qi
        Err1[:, i:i + 1] = err
        W1[:, i:n] -= err * Hinv1[i:i + 1, i:n]


#: (device, rows, width, maxq, codes) -> captured whole-block column loop
_GRAPHS: Dict[tuple, tuple] = {}
_POOL = None


def whole_block(W1, Hinv1, scale, zero, maxq, Q1, Err1, Qi1=None) -> None:
    """:func:`column_loop` over a whole block.  On the card the loop's
    ~10 small launches per column are captured once per block shape as a
    CUDA graph and replayed (the same operations on copies of the
    inputs); on the CPU it runs as it is."""
    global _POOL
    if W1.device.type != "cuda":
        column_loop(W1, Hinv1, scale, zero, maxq, Q1, Err1, Qi1)
        return
    key = (W1.device, W1.shape[0], W1.shape[1], maxq, Qi1 is not None)
    if key not in _GRAPHS:
        static = [t.clone() for t in (W1, Hinv1, scale, zero)]
        outs = [torch.zeros_like(W1) for _ in range(3 if Qi1 is not None
                                                    else 2)]
        args = (*static, maxq, *outs[:2], outs[2] if Qi1 is not None
                else None)
        side = torch.cuda.Stream(W1.device)
        side.wait_stream(torch.cuda.current_stream(W1.device))
        with torch.cuda.stream(side):
            column_loop(*args)                  # warm-up before capture
        torch.cuda.current_stream(W1.device).wait_stream(side)
        if _POOL is None:
            _POOL = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_POOL):
            column_loop(*args)
        _GRAPHS[key] = (graph, static, outs)
    graph, static, outs = _GRAPHS[key]
    for buf, t in zip(static, (W1, Hinv1, scale, zero)):
        buf.copy_(t)
    graph.replay()
    W1.copy_(static[0])
    for dst, src in zip((Q1, Err1, Qi1), outs):
        if dst is not None:
            dst.copy_(src)


def gptq_quantize_weight(W: torch.Tensor, H: torch.Tensor, bits: int,
                         group_size: int = 128, blocksize: int = 128,
                         percdamp: float = 0.01, actorder: bool = False,
                         sym: bool = False) -> torch.Tensor:
    """The fake-quantized weight ``Q`` (W's shape and dtype) of ``W [rows,
    cols]`` under the Hessian ``H [cols, cols]``."""
    rows, cols = W.shape
    per_channel_once = group_size == -1
    if per_channel_once:
        group_size = blocksize
    else:
        assert blocksize % group_size == 0, (blocksize, group_size)
    assert cols % blocksize == 0, (cols, blocksize)
    maxq = 2**bits - 1

    Wf, H = drop_dead_columns(W, H)
    if actorder:
        perm = torch.argsort(-torch.diag(H), stable=True)
        Wf = Wf[:, perm]
        H = H[perm][:, perm]
        invperm = torch.argsort(perm)
    Hinv = inverse_cholesky_upper(H, percdamp)

    if per_channel_once:
        scale, zero = find_params_minmax(Wf, bits, sym=sym)
    Q = torch.zeros_like(Wf)
    for i1 in range(0, cols, blocksize):
        i2 = i1 + blocksize
        W1 = Wf[:, i1:i2].clone()
        Err1 = torch.zeros_like(W1)
        Hinv1 = Hinv[i1:i2, i1:i2]
        Q1 = Q[:, i1:i2]
        if per_channel_once or group_size == blocksize:
            if not per_channel_once:
                scale, zero = find_params_minmax(W1, bits, sym=sym)
            whole_block(W1, Hinv1, scale, zero, maxq, Q1, Err1)
        else:
            for g0 in range(0, blocksize, group_size):
                scale, zero = find_params_minmax(W1[:, g0:g0 + group_size],
                                                 bits, sym=sym)
                column_loop(W1, Hinv1, scale, zero, maxq, Q1, Err1,
                            start=g0, stop=g0 + group_size)
        # the block's errors into the remaining columns
        Wf[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]

    if actorder:
        Q = Q[:, invperm]
    return Q.to(W.dtype)


@torch.inference_mode()
def gptq_quantize_model(params: Dict[str, Any], cfg: ModelConfig,
                        arch: transform.Arch, calib_tokens: np.ndarray,
                        group_size: int = 128, percdamp: float = 0.01,
                        actorder: bool = False, sym: bool = False,
                        batch_size: int = 8, compute_dtype=torch.float32,
                        progress: bool = False,
                        clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Sequential block-by-block GPTQ over the whole model.  The hidden
    states run through the already-quantized blocks, so each block's
    Hessians see its predecessors' quantization error."""
    out = dict(params)
    n, S = calib_tokens.shape
    states, rope = calib.embed_batches(params, cfg, calib_tokens, batch_size,
                                       compute_dtype)
    n_tokens = n * S
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        hessians = calib.layer_hessians(layer, cfg, states, rope,
                                        compute_dtype, clock)
        new_layer = dict(layer)
        with stage(clock, "quantization"):
            for name in LINEAR_NAMES:
                p = layer[name]
                assert isinstance(p, DenseLinear)
                bits = int(round(arch["linear"][name][li]))
                Q = gptq_quantize_weight(p.weight, hessians[name]
                                         * (2.0 / n_tokens), bits,
                                         group_size=group_size,
                                         percdamp=percdamp,
                                         actorder=actorder, sym=sym)
                new_layer[name] = DenseLinear(weight=Q, bias=p.bias)
                if progress:
                    err = float(torch.mean((Q.float() - p.weight.float()) ** 2))
                    print(f"gptq block {li} {name}: bits={bits} "
                          f"mse={err:.3e}", flush=True)
        del hessians
        states = calib.propagate(new_layer, cfg, states, rope, compute_dtype,
                                 clock)
        out_layers.append(new_layer)
    out["layers"] = out_layers
    return out
