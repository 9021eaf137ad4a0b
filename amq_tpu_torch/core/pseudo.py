"""Simulated (fake) quantizers of the PTQ algorithms, in PyTorch.

The port of the JAX package's ``core/pseudo.py``:

* :func:`pseudo_quantize` -- AWQ's group-wise asymmetric min/max
  fake-quant,
* :func:`find_params_minmax` -- GPTQ's per-row min/max parameters with the
  optional MSE grid over range shrinks (``mse`` / ``grid`` / ``maxshrink``
  / ``norm``),
* :func:`quantize_affine` -- GPTQ's elementwise fake-quant.

All take ``[out, in]`` weights and compute in float32 on the weight's own
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def pseudo_quantize(w: torch.Tensor, n_bit: int,
                    group_size: int = 128) -> torch.Tensor:
    """AWQ group-wise asymmetric fake-quant: ``scales = clamp(max - min,
    1e-5) / (2^b - 1)``, ``zeros = clamp(-round(min / scales), 0,
    2^b - 1)``.  Returns w's shape and dtype."""
    g = group_size if group_size > 0 else w.shape[-1]
    wg = w.float().reshape(-1, g)
    max_val = wg.amax(dim=1, keepdim=True)
    min_val = wg.amin(dim=1, keepdim=True)
    max_int = 2**n_bit - 1
    scales = torch.clamp(max_val - min_val, min=1e-5) / max_int
    zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)
    q = torch.clamp(torch.round(wg / scales) + zeros, 0, max_int)
    return ((q - zeros) * scales).reshape(w.shape).to(w.dtype)


def quantize_affine(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    maxq) -> torch.Tensor:
    """``scale * (clip(round(x / scale) + zero, 0, maxq) - zero)``."""
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


class MinMaxParams(NamedTuple):
    scale: torch.Tensor
    zero: torch.Tensor


def find_params_minmax(x: torch.Tensor, bits: int, sym: bool = False,
                       mse: bool = False, grid: int = 100,
                       maxshrink: float = 0.8,
                       norm: float = 2.4) -> MinMaxParams:
    """Per-row quant params of ``x [rows, cols]`` -> scale / zero
    ``[rows, 1]``.  With ``mse`` the range shrinks ``p = 1 - i / grid``
    for ``i < maxshrink * grid`` are scored by ``sum |q - x|^norm`` and
    the first strictly best shrink per row is kept (all shrinks are
    scored in one batched pass)."""
    maxq = 2**bits - 1
    x = x.float()
    xmin = torch.clamp(x.amin(dim=1), max=0.0)
    xmax = torch.clamp(x.amax(dim=1), min=0.0)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    both_zero = (xmin == 0) & (xmax == 0)
    xmin = torch.where(both_zero, torch.full_like(xmin, -1.0), xmin)
    xmax = torch.where(both_zero, torch.full_like(xmax, 1.0), xmax)

    scale = (xmax - xmin) / maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if mse:
        n = int(maxshrink * grid)
        p = 1 - torch.arange(n, dtype=torch.float32, device=x.device) / grid
        xmin1 = p[:, None] * xmin                            # [n, rows]
        xmax1 = p[:, None] * xmax
        scale1 = (xmax1 - xmin1) / maxq
        zero1 = (torch.round(-xmin1 / scale1) if not sym
                 else zero.expand_as(scale1))
        q = quantize_affine(x, scale1[..., None], zero1[..., None], maxq)
        err = torch.sum(torch.abs(q - x) ** norm, dim=2)     # [n, rows]
        # the loop's strict improvement over +inf: the first minimum
        best = torch.argmin(err, dim=0)
        ok = torch.isfinite(err.gather(0, best[None]))[0]
        rows = torch.arange(x.shape[0], device=x.device)
        scale = torch.where(ok, scale1[best, rows], scale)
        zero = torch.where(ok, zero1[best, rows], zero)

    return MinMaxParams(scale=scale[:, None], zero=zero[:, None])
