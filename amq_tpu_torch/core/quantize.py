"""Group-wise affine weight quantization (HQQ) in PyTorch.

The same numerics as the JAX package's ``core/quantize.py``: groups of
``group_size`` consecutive in-features per out-row, inverse-scale
``q = round(W * scale + zero)`` with ``scale = (2^b - 1) / (max - min)``
(small-denominator guard 1e-4, clamp 2e4), optional zero rounding (on for
4-bit), the 20-step proximal zero-point solver, and stored meta inverted
so dequantization is ``(q - zero) * scale``.  Everything runs in float32;
codes are packed transposed ``[K, N]`` in the pair-planar layout of
:mod:`amq_tpu_torch.core.bitpack`, scale/zero are ``[K/g, N]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import bitpack


@dataclasses.dataclass
class QuantizedTensor:
    """A group-quantized linear weight in packed form (``kn`` layout)."""

    packed: torch.Tensor   # int32 [Kp * nbits / 32, Np] (uint32 bits)
    scale: torch.Tensor    # [Kp / g, Np] dequant scale
    zero: torch.Tensor     # [Kp / g, Np]
    nbits: int
    group_size: int
    shape: tuple           # logical (out, in)
    #: planar packing block (= the kernels' K step); 0 -> group_size
    superblock: int = 0

    @property
    def superblock_(self) -> int:
        return self.superblock or self.group_size

    @property
    def out_features(self) -> int:
        return self.shape[0]

    @property
    def in_features(self) -> int:
        return self.shape[1]


def _shrink_lp(x: torch.Tensor, beta, lp_norm: float) -> torch.Tensor:
    """lp shrinkage operator."""
    a = x.abs()
    if lp_norm == 1:
        out = torch.clamp(a - 1.0 / beta, min=0.0)
    else:
        out = torch.clamp(a - (1.0 / beta) * a ** (lp_norm - 1), min=0.0)
    return out * torch.sign(x)


def optimize_zero_proximal(Wg: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, max_v: float,
                           lp_norm: float = 0.7, beta: float = 10.0,
                           kappa: float = 1.01, iters: int = 20) -> torch.Tensor:
    """Proximal zero-point refinement on grouped weights ``[n_groups, g]``.

    Each step rounds/clamps, shrinks the residual and re-estimates the
    zero point; updates stop (by masking, so nothing is read back to the
    host) once the mean absolute reconstruction error stops improving.
    ``scale`` is the forward scale (multiplied).
    """
    betas = beta * kappa ** torch.arange(iters, dtype=Wg.dtype,
                                         device=Wg.device)
    zero_c, best_zero = zero, zero
    best_err = torch.tensor(float("inf"), dtype=Wg.dtype, device=Wg.device)
    done = torch.tensor(False, device=Wg.device)
    for i in range(iters):
        W_q = torch.clamp(torch.round(Wg * scale + zero_c), 0.0, max_v)
        W_r = (W_q - zero_c) / scale
        err = torch.mean(torch.abs(Wg - W_r))
        improved = err < best_err
        take = improved & ~done
        best_zero = torch.where(take, zero_c, best_zero)
        best_err = torch.where(take, err, best_err)
        done = done | ~improved
        W_e = _shrink_lp(Wg - W_r, betas[i], lp_norm)
        zero_n = torch.mean(W_q - (Wg - W_e) * scale, dim=1, keepdim=True)
        zero_c = torch.where(done, zero_c, zero_n)
    return best_zero


def quantize(W: torch.Tensor, nbits: int = 4, group_size: int = 128,
             optimize: bool = True, round_zero: Optional[bool] = None,
             meta_dtype=torch.float32,
             superblock: Optional[int] = None) -> QuantizedTensor:
    """HQQ-quantize an ``[out, in]`` weight into a :class:`QuantizedTensor`.

    ``round_zero`` defaults to ``nbits == 4``.  ``meta_dtype`` is the
    scale/zero storage type (bfloat16 halves the metadata stream).
    ``superblock=None`` picks the padded superblock (K rounds up to whole
    blocks; pad codes/scale/zero are zero and dequantize to 0).
    """
    assert nbits in bitpack.SUPPORTED_BITS, nbits
    out_f, in_f = W.shape
    assert in_f % group_size == 0, (W.shape, group_size)
    if round_zero is None:
        round_zero = nbits == 4

    Wg = W.to(torch.float32).reshape(-1, group_size)
    _min = Wg.amin(dim=1, keepdim=True)
    _max = Wg.amax(dim=1, keepdim=True)
    max_v = float(round(2**nbits - 1))

    denom = _max - _min
    scale = max_v / denom
    scale = torch.where(denom.abs() <= 1e-4, torch.ones_like(scale), scale)
    scale = torch.clamp(scale, max=2e4)
    zero = -_min * scale
    if round_zero:
        zero = torch.round(zero)
    if optimize:
        zero = optimize_zero_proximal(Wg, scale, zero, max_v)

    W_q = torch.clamp(torch.round(Wg * scale + zero), 0.0, max_v)

    n_groups = in_f // group_size
    scale_t = (1.0 / scale).reshape(out_f, n_groups).T.to(meta_dtype)
    zero_t = zero.reshape(out_f, n_groups).T.to(meta_dtype)
    codes_kn = W_q.reshape(out_f, in_f).T.to(torch.int64)     # [K, N]
    if superblock:
        k_pad = 0
        assert in_f % superblock == 0, (in_f, superblock)
    else:
        superblock, k_pad = bitpack.pick_superblock_padded(in_f, group_size)
    if k_pad:
        codes_kn = torch.nn.functional.pad(codes_kn, (0, 0, 0, k_pad))
        scale_t = torch.nn.functional.pad(scale_t, (0, 0, 0, k_pad // group_size))
        zero_t = torch.nn.functional.pad(zero_t, (0, 0, 0, k_pad // group_size))
    return QuantizedTensor(
        packed=bitpack.pack(codes_kn, nbits, superblock),
        scale=scale_t.contiguous(), zero=zero_t.contiguous(),
        nbits=nbits, group_size=group_size, shape=(out_f, in_f),
        superblock=superblock)


def to_container(qt: QuantizedTensor, container_bits: int) -> QuantizedTensor:
    """Repack the same codes into wider ``container_bits`` fields (3-bit
    codes served in 4-bit nibbles); scale and zero are untouched, so the
    dequantized weight is bit-identical."""
    assert container_bits >= qt.nbits, (qt.nbits, container_bits)
    if container_bits == qt.nbits:
        return qt
    codes = bitpack.unpack(qt.packed, qt.nbits, qt.superblock_)
    packed = bitpack.pack(codes, container_bits, qt.superblock_)
    return dataclasses.replace(qt, packed=packed, nbits=container_bits)


def dequantize_kn(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to the transposed ``[in, out]`` layout (logical block):
    int32 codes, then ``(c - z) * s`` in ``dtype``.  Plain PyTorch on any
    device; ``ops.dequant.dequantize_kn`` is the CUDA kernel held to it."""
    codes = bitpack.unpack(qt.packed, qt.nbits, qt.superblock_)   # [Kp, Np]
    K, N = codes.shape
    g = qt.group_size
    c = codes.reshape(K // g, g, N).to(dtype)
    scale = qt.scale.reshape(K // g, 1, N).to(dtype)
    zero = qt.zero.reshape(K // g, 1, N).to(dtype)
    w = ((c - zero) * scale).reshape(K, N)
    return w[:qt.in_features, :qt.out_features]


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize back to the original ``[out, in]`` weight."""
    return dequantize_kn(qt, dtype).T.reshape(qt.shape)
