"""Sub-byte bit packing in the JAX package's pair-planar layout.

Quantized codes are stored transposed relative to the torch weight: an
``[out, in]`` weight becomes a code matrix ``[K, N]`` (K = in-features,
the reduction axis; N = out-features).  Packing is planar per block (the
"superblock", which is also the CUDA kernels' K step):

* a block of ``g`` K-rows packs into ``R = g * nbits / 32`` 32-bit rows,
* the value at block row ``k = p*2R + 2r + h`` lives in word row ``r`` at
  bit offset ``16*h + nbits*p`` (``p`` = extraction round, ``h`` = 16-bit
  half),
* 3/5/6-bit are a hi plane (``codes >> lo``) followed by a lo plane
  (``codes & (2**lo - 1)``), each pair-planar; 3-bit is 2 + 1.

torch on the CPU has no ``>>`` for ``torch.uint32``, so packed words are
held as ``torch.int32`` with the same bits: words are built in int64 and
wrapped (bit 31 is used, e.g. by 8-bit codes at shift 24), and every
extraction masks after the (arithmetic) shift.
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (1, 2, 3, 4, 5, 6, 8)

#: non-power-of-two widths as (hi_bits, lo_bits) plane pairs
_PLANE_SPLIT = {3: (2, 1), 5: (4, 1), 6: (4, 2)}


def packed_rows(group_size: int, nbits: int) -> int:
    """Packed 32-bit rows for ``group_size`` K-rows at ``nbits``."""
    assert (group_size * nbits) % 32 == 0, (group_size, nbits)
    return group_size * nbits // 32


def pick_superblock(K: int, group_size: int = 128,
                    candidates=(1024, 512, 256, 128)) -> int:
    """Largest packing block dividing K (and a multiple of the group)."""
    for c in candidates:
        if K % c == 0 and c % group_size == 0:
            return c
    raise ValueError(f"no superblock for K={K}, group={group_size}")


def pick_superblock_padded(K: int, group_size: int = 128,
                           candidates=(1024, 512, 256, 128)):
    """``(superblock, k_pad)`` allowing K to round up to a big block when
    the pad is bounded (<= block/2 and <= K/8): Llama's 11008 becomes
    1024-blocks with 256 zero rows."""
    for c in candidates:
        pad = -K % c
        if c % group_size == 0 and pad <= min(c // 2, K // 8):
            return c, pad
    raise ValueError(f"no superblock for K={K}, group={group_size}")


def wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_pow2_group(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """``[G, g, N]`` int64 codes -> ``[G, g*b/32, N]`` int64 words."""
    G, g, N = codes.shape
    rows = g * nbits // 32
    P = 16 // nbits
    c = codes.reshape(G, P, rows, 2, N)
    word = torch.zeros((G, rows, N), dtype=torch.int64, device=codes.device)
    for p in range(P):
        for h in range(2):
            word |= c[:, p, :, h] << (16 * h + nbits * p)
    return word


def _unpack_pow2_group(words: torch.Tensor, nbits: int,
                       group_size: int) -> torch.Tensor:
    """Inverse of :func:`_pack_pow2_group` on int32 words: ``[G, rows, N]``
    -> ``[G, g, N]``.  One broadcast shift and mask over the shifts
    ``nbits*p + 16*h`` shaped ``[P, 1, 2, 1]``: block row ``p*2R + 2r + h``
    comes out in K order."""
    G, rows, N = words.shape
    P = 16 // nbits
    shifts = (nbits * torch.arange(P, dtype=torch.int32,
                                   device=words.device).reshape(P, 1, 1, 1)
              + 16 * torch.arange(2, dtype=torch.int32,
                                  device=words.device).reshape(1, 1, 2, 1))
    codes = (words[:, None, :, None, :] >> shifts) & (2**nbits - 1)
    return codes.reshape(G, group_size, N)


def pack(codes: torch.Tensor, nbits: int, group_size: int = 128) -> torch.Tensor:
    """Pack integer codes ``[K, N]`` -> int32 words ``[K * nbits / 32, N]``.

    ``group_size`` is the packing block (pass the superblock for
    kernel-facing tensors); K must be a multiple of it.
    """
    assert nbits in SUPPORTED_BITS, nbits
    K, N = codes.shape
    assert K % group_size == 0, (K, group_size)
    G = K // group_size
    grouped = codes.to(torch.int64).reshape(G, group_size, N)
    if nbits in _PLANE_SPLIT:
        hb, lb = _PLANE_SPLIT[nbits]
        hi = _pack_pow2_group((grouped >> lb) & (2**hb - 1), hb)
        lo = _pack_pow2_group(grouped & (2**lb - 1), lb)
        word = torch.cat([hi, lo], dim=1)            # [G, (hb+lb)*g/32, N]
    else:
        word = _pack_pow2_group(grouped, nbits)
    return wrap_int32(word.reshape(G * packed_rows(group_size, nbits), N))


def unpack(words: torch.Tensor, nbits: int, group_size: int = 128,
           dtype=torch.int32) -> torch.Tensor:
    """Unpack int32 (or int64) words ``[K * nbits / 32, N]`` -> codes ``[K, N]``.

    The codes are extracted from int32 words (int64 words in ``[0, 2**32)``
    are wrapped first): no int64 intermediates."""
    assert nbits in SUPPORTED_BITS, nbits
    rows = packed_rows(group_size, nbits)
    R, N = words.shape
    assert R % rows == 0, (R, rows)
    G = R // rows
    if words.dtype == torch.int64:
        words = wrap_int32(words)
    w = words.reshape(G, rows, N)
    if nbits in _PLANE_SPLIT:
        hb, lb = _PLANE_SPLIT[nbits]
        hi_rows = packed_rows(group_size, hb)
        hi = _unpack_pow2_group(w[:, :hi_rows], hb, group_size)
        lo = _unpack_pow2_group(w[:, hi_rows:], lb, group_size)
        out = (hi << lb) | lo
    else:
        out = _unpack_pow2_group(w, nbits, group_size)
    return out.reshape(G * group_size, N).to(dtype)
