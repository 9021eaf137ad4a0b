"""OWQ: outlier-aware weight quantization (GPTQ + float outlier columns).

The port of the JAX package's ``quantization/owq.py``:

* outlier budget: with the 32/g scale-zero overhead taken off the target,
  ``r = (12 / (16 - avg_bits)) * 0.1 / n_linear`` and per linear
  ``n_out = round(in_dim * r * ratio)`` rounded up to even (ratio 1.0 for
  attention, 0.375 for the MLP),
* outliers: the top-``n_out`` columns by ``diag(H) * frob_error``, the
  per-column squared error of an MSE-grid quantization of W,
* columns permuted so the outliers sit last; the GPTQ column loop runs
  over the ``n_nonout`` others only; the outlier columns take error
  feedback and stay float,
* quantizer: the asymmetric MSE grid over (range shrink x zero point),
  lp-norm 2.4, ``num = 40`` at group boundaries (:func:`find_params_mse_grid`
  scores every grid point as one tensor dimension).

Packed serving (:class:`OWQPacked`, :func:`owq_pack`, :func:`owq_matmul`):
the non-outlier columns packed as a :class:`QuantizedTensor` over the
compacted K, served by ``ops.quant_matmul`` on the card, plus a float
product over the outlier columns.  x is compacted with ``index_select``
on a device index (the JAX package slices it statically).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import bitpack
from ..core.quantize import QuantizedTensor
from ..models import transform
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import DenseLinear, OWQLinear, matmul_f32
from . import calib
from .calib import StageClock, stage
from .gptq import (column_loop, drop_dead_columns, inverse_cholesky_upper,
                   whole_block)

# per-linear outlier ratios (the reference's model_config.json "ratios")
OWQ_RATIOS = {
    "self_attn.q_proj": 1.0,
    "self_attn.k_proj": 1.0,
    "self_attn.v_proj": 1.0,
    "self_attn.o_proj": 1.0,
    "mlp.up_proj": 0.375,
    "mlp.gate_proj": 0.375,
    "mlp.down_proj": 0.375,
}

#: elements of one [grid, rows, cols] score tensor before rows are chunked
_GRID_ELEMS = 1 << 26


def compute_n_out(cfg: ModelConfig, avg_bits: float,
                  group_size: int = 128) -> Dict[str, int]:
    """Outlier columns per linear site."""
    if group_size > 0:
        avg_bits = avg_bits - 32.0 / group_size
    r = (12.0 / (16.0 - avg_bits)) * 0.1 / len(LINEAR_NAMES)
    out = {}
    for name in LINEAR_NAMES:
        n_out = round(cfg.linear_shape(name)[1] * r * OWQ_RATIOS[name])
        if n_out % 2 == 1:
            n_out += 1
        out[name] = n_out
    return out


def _mse_grid_rows(xf, m, n_valid, bits, num, eps=1e-8):
    """(best_min, best_max) per row of ``xf`` over the (shrink, zero
    point) grid, the first strictly best point in (shrink, zero point)
    order, as the JAX loops take it."""
    maxq = 2**bits - 1
    xmin = torch.clamp(xf.amin(dim=1), max=0.0)
    xmax = torch.clamp(xf.amax(dim=1), min=0.0)
    xrange = xmax - xmin
    steps = torch.arange(1, num + 1, dtype=torch.float32, device=xf.device)
    tmp_max = (xrange / num)[None, :] * steps[:, None]          # [num, rows]
    scale = torch.clamp(tmp_max / maxq, min=eps)
    s3 = scale[..., None]
    x_round = torch.round(xf[None] / s3)                         # [num, r, c]
    scores = []
    for zp in range(2**bits):
        new_min = -float(zp) * scale
        zero = torch.clamp(-torch.round(new_min / scale), 0, maxq)[..., None]
        # e = |x - scale * (clip(x_round + zero) - zero)| ** 2.4, in place
        e = torch.clamp(x_round + zero, 0, maxq).sub_(zero).mul_(s3)
        e.sub_(xf[None]).abs_().pow_(2.4)
        if m is not None:
            scores.append(torch.sum(e.masked_fill_(~m, 0.0), dim=2) / n_valid)
        else:
            scores.append(torch.mean(e, dim=2))
    scores = torch.stack(scores, dim=1)               # [num, levels, rows]
    rows = xf.shape[0]
    flat = scores.reshape(-1, rows)
    best = torch.argmin(flat, dim=0)                  # first minimum
    ok = flat.gather(0, best[None])[0] < 1e10
    i_best = best // (2**bits)
    zp_best = (best % (2**bits)).float()
    r = torch.arange(rows, device=xf.device)
    sc = scale[i_best, r]
    best_min = torch.where(ok, -zp_best * sc, xmin)
    best_max = torch.where(ok, tmp_max[i_best, r] - zp_best * sc, xmax)
    return best_min, best_max


def find_params_mse_grid(x: torch.Tensor, bits: int, num: int = 100,
                         col_mask: Optional[torch.Tensor] = None):
    """Asymmetric MSE-grid quant params per row of ``x [rows, cols]``;
    ``col_mask [cols]`` marks the valid columns (a group window clipped at
    the outlier boundary).  Returns (scale, zero), each ``[rows, 1]``."""
    maxq = 2**bits - 1
    eps = 1e-8
    xf = x.float()
    m, n_valid = None, xf.shape[1]
    if col_mask is not None:
        m = col_mask[None, :]
        n_valid = torch.clamp(torch.sum(m), min=1)
        xf = torch.where(m, xf, 0.0)
    chunk = max(1, _GRID_ELEMS // (num * xf.shape[1]))
    mins, maxs = [], []
    for r in range(0, xf.shape[0], chunk):
        a, b = _mse_grid_rows(xf[r:r + chunk], m, n_valid, bits, num, eps)
        mins.append(a)
        maxs.append(b)
    best_min, best_max = torch.cat(mins), torch.cat(maxs)
    min_neg = torch.clamp(best_min, max=0.0)
    max_pos = torch.clamp(best_max, min=0.0)
    scale = torch.clamp((max_pos - min_neg) / maxq, min=eps)
    zero = torch.clamp(-torch.round(min_neg / scale), 0, maxq)
    return scale[:, None], zero[:, None]


def _quantize_codes(x, scale, zero, maxq):
    return torch.clamp(torch.round(x / scale) + zero, 0, maxq)


def owq_quantize_weight(W: torch.Tensor, H: torch.Tensor, bits: int,
                        n_out: int, group_size: int = 128,
                        blocksize: int = 128, percdamp: float = 0.01,
                        num_boundary: int = 40, return_packed: bool = False):
    """OWQ's fasterquant: the fake-quantized W with its outlier columns
    kept float (error feedback included).  ``return_packed=True`` also
    returns the serving pieces: integer codes and per-column scale / zero
    over the permuted non-outlier columns, the permutation, and the float
    outlier columns."""
    rows, cols = W.shape
    n_nonout = cols - n_out
    maxq = 2**bits - 1
    Wf = W.float()
    H = H.float()

    # outliers: diag(H) * the Frobenius error of an MSE-grid quantization
    fp_scale, fp_zero = find_params_mse_grid(Wf, bits, num=num_boundary)
    W_quant = fp_scale * (_quantize_codes(Wf, fp_scale, fp_zero, maxq)
                          - fp_zero)
    frob = torch.sum((Wf - W_quant) ** 2, dim=0)
    h_score = torch.diag(H) * frob
    desc = torch.argsort(-h_score, stable=True)
    is_out = torch.zeros(cols, dtype=torch.bool, device=W.device)
    is_out[desc[:n_out]] = True
    # non-outliers in their order, outliers appended in theirs
    order = torch.argsort(is_out.to(torch.int8), stable=True)
    inv_order = torch.argsort(order)

    Wp, Hp = drop_dead_columns(Wf[:, order], H[order][:, order])
    Hinv = inverse_cholesky_upper(Hp, percdamp)

    Q = torch.zeros_like(Wp)
    Qint = torch.zeros_like(Wp)
    Scales = torch.ones_like(Wp)
    Zeros = torch.zeros_like(Wp)
    iota = torch.arange(group_size, device=W.device)
    assert blocksize % group_size == 0, (blocksize, group_size)
    for i1 in range(0, n_nonout, blocksize):
        i2 = min(i1 + blocksize, n_nonout)
        n = i2 - i1
        W1 = Wp[:, i1:i1 + blocksize].clone()
        Err1 = torch.zeros((rows, n), dtype=torch.float32, device=W.device)
        Hinv1 = Hinv[i1:i2, i1:i2]
        for g0 in range(0, n, group_size):
            # the group window, clipped at the outlier boundary
            scale, zero = find_params_mse_grid(
                W1[:, g0:g0 + group_size], bits, num=num_boundary,
                col_mask=(iota + i1 + g0) < n_nonout)
            c0, c1 = i1 + g0, i1 + min(g0 + group_size, n)
            Scales[:, c0:c1] = scale
            Zeros[:, c0:c1] = zero
            outs = (Q[:, i1:i2], Err1, Qint[:, i1:i2])
            if n == group_size == W1.shape[1]:
                whole_block(W1, Hinv1, scale, zero, maxq, *outs)
            else:
                column_loop(W1, Hinv1, scale, zero, maxq, *outs, start=g0,
                            stop=min(g0 + group_size, n), n=n)
        # the block's errors into every later column, the outliers too
        Wp[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]

    # outlier columns: the float values with error compensation
    Q[:, n_nonout:] = Wp[:, n_nonout:]
    Qo = Q[:, inv_order].to(W.dtype)
    if not return_packed:
        return Qo
    return Qo, {"codes": Qint[:, :n_nonout], "scale": Scales[:, :n_nonout],
                "zero": Zeros[:, :n_nonout], "order": order,
                "n_nonout": n_nonout, "w_out": Wp[:, n_nonout:]}


@dataclasses.dataclass
class OWQPacked:
    """One linear in OWQ serving form.

    ``qt`` covers the non-outlier input columns in their order (padded to
    a group multiple with zero codes); ``w_out [n_out, N]`` holds the float
    outlier columns.  ``segments`` (contiguous runs of non-outlier columns)
    and ``out_ids`` (outlier columns, ascending) are the static layout;
    ``main_idx`` / ``out_idx`` are the same columns as device indices, the
    compaction's ``index_select``."""

    qt: QuantizedTensor
    w_out: torch.Tensor
    segments: tuple
    out_ids: tuple
    main_idx: torch.Tensor
    out_idx: torch.Tensor

    @classmethod
    def from_layout(cls, qt, w_out, segments, out_ids) -> "OWQPacked":
        dev = w_out.device
        main = [c for a, b in segments for c in range(a, b)]
        return cls(qt=qt, w_out=w_out, segments=tuple(segments),
                   out_ids=tuple(int(i) for i in out_ids),
                   main_idx=torch.tensor(main, dtype=torch.int64, device=dev),
                   out_idx=torch.tensor(list(out_ids), dtype=torch.int64,
                                        device=dev))


def outlier_segments(out_ids, n_cols: int) -> tuple:
    """Contiguous (start, stop) runs of non-outlier columns, in order."""
    segs, start = [], 0
    for i in sorted(int(i) for i in out_ids):
        if i > start:
            segs.append((start, i))
        start = i + 1
    if start < n_cols:
        segs.append((start, n_cols))
    return tuple(segs)


def owq_pack(W: torch.Tensor, H: torch.Tensor, bits: int, n_out: int,
             group_size: int = 128, percdamp: float = 0.01) -> tuple:
    """Quantize and pack: (fake-quant W, :class:`OWQPacked`)."""
    rows, cols = W.shape
    n_nonout = cols - n_out
    Q, parts = owq_quantize_weight(W, H, bits, n_out, group_size=group_size,
                                   percdamp=percdamp, return_packed=True)
    n_groups = -(-n_nonout // group_size)
    Kp = n_groups * group_size
    codes = torch.zeros((rows, Kp), dtype=torch.int64, device=W.device)
    codes[:, :n_nonout] = parts["codes"].to(torch.int64)
    # per-group scale / zero: constant within each (clipped) group window
    first = torch.arange(n_groups, device=W.device) * group_size
    sc = parts["scale"][:, first]
    zp = parts["zero"][:, first]
    superblock = bitpack.pick_superblock(Kp, group_size)
    qt = QuantizedTensor(
        packed=bitpack.pack(codes.T.contiguous(), bits, superblock),
        scale=sc.T.contiguous(), zero=zp.T.contiguous(), nbits=bits,
        group_size=group_size, shape=(rows, Kp), superblock=superblock)
    order = parts["order"]
    out_cols = order[n_nonout:]
    w_out = parts["w_out"].T[torch.argsort(out_cols)].contiguous()
    out_ids = sorted(int(i) for i in out_cols.tolist())
    return Q, OWQPacked.from_layout(qt, w_out,
                                    outlier_segments(out_ids, cols), out_ids)


def owq_matmul(x: torch.Tensor, p: OWQPacked, out_dtype=None,
               use_kernel: bool = True) -> torch.Tensor:
    """``x @ W_owq.T`` in packed serving form: the dequant-matmul over the
    compacted non-outlier columns (``ops.quant_matmul`` on a CUDA tensor
    when ``use_kernel``, else ``quant_matmul_reference``) plus the float
    product over the outlier columns.  The pad columns of the compacted x
    are zeros, so their codes contribute nothing."""
    from ..ops.quant_matmul import quant_matmul, quant_matmul_reference

    Kp = p.qt.in_features
    x_main = x.index_select(-1, p.main_idx)
    if Kp > x_main.shape[-1]:
        x_main = torch.nn.functional.pad(x_main, (0, Kp - x_main.shape[-1]))
    mm = (quant_matmul if use_kernel and x.device.type == "cuda"
          else quant_matmul_reference)
    y = mm(x_main.contiguous(), p.qt)
    if p.out_ids:
        x_out = x.index_select(-1, p.out_idx)
        y = y + matmul_f32(x_out, p.w_out, None, y.dtype)
    return y.to(out_dtype or x.dtype)


@torch.inference_mode()
def owq_quantize_model(params: Dict[str, Any], cfg: ModelConfig,
                       arch: transform.Arch, avg_bits: float,
                       calib_tokens: np.ndarray, group_size: int = 128,
                       percdamp: float = 0.01, batch_size: int = 8,
                       compute_dtype=torch.float32, progress: bool = False,
                       packed: bool = False,
                       clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """Sequential block-by-block OWQ over the whole model.  ``packed=True``
    realizes each linear as an :class:`OWQLinear` (serving form); the
    hidden states still run through the fake-quant weights, so the
    quantization order matches the evaluation path."""
    n_out = compute_n_out(cfg, avg_bits, group_size)
    n, S = calib_tokens.shape
    states, rope = calib.embed_batches(params, cfg, calib_tokens, batch_size,
                                       compute_dtype)
    n_tokens = n * S
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        hessians = calib.layer_hessians(layer, cfg, states, rope,
                                        compute_dtype, clock)
        new_layer = dict(layer)
        packed_layer = dict(layer)
        with stage(clock, "quantization"):
            for name in LINEAR_NAMES:
                p = layer[name]
                bits = int(round(arch["linear"][name][li]))
                H = hessians[name] * (2.0 / n_tokens)
                if packed:
                    Q, pk = owq_pack(p.weight, H, bits, n_out=n_out[name],
                                     group_size=group_size, percdamp=percdamp)
                    packed_layer[name] = OWQLinear(packed=pk, bias=p.bias)
                else:
                    Q = owq_quantize_weight(p.weight, H, bits,
                                            n_out=n_out[name],
                                            group_size=group_size,
                                            percdamp=percdamp)
                new_layer[name] = DenseLinear(weight=Q, bias=p.bias)
                if progress:
                    print(f"owq block {li} {name}: bits={bits} "
                          f"n_out={n_out[name]}", flush=True)
        del hessians
        states = calib.propagate(new_layer, cfg, states, rope, compute_dtype,
                                 clock)
        out_layers.append(packed_layer if packed else new_layer)
    out = dict(params)
    out["layers"] = out_layers
    return out
