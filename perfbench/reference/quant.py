"""Round-to-nearest group quantization, the proxies of the search cell.

Per output row and group of ``group`` in-features: ``inv = (2**bits - 1)
/ (max - min)`` (denominator at least 1e-4), ``zero = -min * inv``,
``code = clamp(round(w * inv + zero), 0, 2**bits - 1)``; scale ``1 / inv``
and zero are stored in bf16, and the weight is ``(code - zero) * scale``.
"""

from __future__ import annotations

import torch


def rtn(weight: torch.Tensor, bits: int, group: int):
    """``(codes [out, in] float32, scale, zero [out, in / group] bf16)`` of
    a dense ``[out, in]`` weight."""
    out_f, in_f = weight.shape
    W = weight.float().reshape(out_f, in_f // group, group)
    lo, hi = W.amin(-1, keepdim=True), W.amax(-1, keepdim=True)
    top = 2**bits - 1
    inv = top / (hi - lo).clamp(min=1e-4)
    zero = -lo * inv
    codes = torch.clamp(torch.round(W * inv + zero), 0, top)
    return (codes.reshape(out_f, in_f), (1.0 / inv)[..., 0].to(torch.bfloat16),
            zero[..., 0].to(torch.bfloat16))


def rtn_weight(weight: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """The ``[in, out]`` float32 weight the proxy at ``bits`` stands for."""
    codes, scale, zero = rtn(weight, bits, group)
    out_f, in_f = codes.shape
    w = ((codes.reshape(out_f, in_f // group, group) - zero.float()[..., None])
         * scale.float()[..., None])
    return w.reshape(out_f, in_f).T
