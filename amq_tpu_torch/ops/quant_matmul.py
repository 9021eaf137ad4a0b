"""Fused unpack -> dequantize -> matmul: wrappers and plain versions.

Each public function here replaces one Pallas kernel of the JAX package's
``ops/quant_matmul.py`` and has three parts:

* the CUDA kernel (``csrc/quant_matmul.cu``, one template over nbits in
  {1, 2, 3, 4, 8}: calls with bf16 activations and M <= 8 take the grouped
  tensor-core GEMV, the JAX package's serving form, where its conditions
  hold (:func:`_grouped_applies`: every superblock of 128 rows and up
  below 8 bits, whole ring stages at 8); calls with bf16 activations and 8 < M
  the tile kernel on wgmma (``csrc/quant_matmul_tile.cu``, the JAX
  package's bf16 multi-row form: each weight tile dequantized once, in
  bf16) where :func:`_tile_applies` says so; calls with f32 activations
  the same two predicates send to the float32 forms of both on tensor
  cores (``csrc/quant_matmul_f32.cu`` and ``qmm_tile_f32_kernel``: exact
  codes against x split once into three bf16 parts, the JAX package's f32
  function, reference :func:`qmm_exact_plain`); other calls the CUDA-core
  decode GEMV (M <= 8) or the CUDA-core GEMM (8 < M), the JAX package's
  f32 form), launched for CUDA tensors,
* a plain PyTorch version of the same function, taken only for CPU
  tensors: :func:`qmm_tile_plain` for bf16 activations and 8 < M, else
  :func:`qmm_plain` (dequantize in float32, then a float32 product),
* a launch counter (``<function>.launches``), raised where the kernel is
  launched and nowhere else; beside it ``<function>.grouped_launches`` and
  ``<function>.tile_launches`` count the launches that took the grouped
  GEMV and the tile kernel, ``<function>.span_launches`` the grouped
  ones at layouts whose superblocks are smaller than a ring stage (the
  grouped GEMV's spanning kernel), and ``<function>.pair_launches`` /
  ``<function>.pair_tile_launches`` the grouped / tile ones at 4-row
  superblocks (1 and 3 bits at 128 rows: the pair forms).

Under the JAX package's ``AMQ_PIPE`` switch (read once, at import, into
``_PIPE_DEFAULT``; default off) the decode GEMVs of
``quant_matmul_indexed`` and ``quant_matmul_swiglu_indexed`` take the
software-pipelined grouped GEMV (``csrc/quant_matmul_pipe.cu``) where
:func:`_pipe_applies` says so, and count under their own names
(``quant_matmul_indexed_pipe``, ``quant_matmul_swiglu_indexed_pipe``).
``quant_matmul_mlp_indexed`` is the one-launch decode MLP
(``csrc/quant_matmul_mlp.cu``) of the ``AMQ_MLP_KERNEL`` switch.  Both
compute the grouped form on the grouped GEMV's ring
(``csrc/qmm_grouped.cuh``), bit-identical to the grouped GEMV and its
gateup -> SwiGLU-down chain.

A CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises.  The kernels read the JAX storage layout as is (see
``core/bitpack.py``), take the layer of a stacked buffer as a view (no copy
of the layer), zero x over the K pad, and return only the logical N
columns.  What bounds them on the H100 (bytes) and what the design does
about it is set out at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from ..core import bitpack
from ..core.quantize import QuantizedTensor, dequantize_kn
from . import _cuda

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


#: the JAX package's AMQ_PIPE switch: qualifying decode GEMVs take the
#: software-pipelined kernel (see :func:`_pipe_applies`)
_PIPE_DEFAULT = int(os.environ.get("AMQ_PIPE", "0"))


_SOURCE = {"amq_qmm_pipe": "quant_matmul_pipe",
           "amq_qmm_tile": "quant_matmul_tile",
           "amq_qmm_tile_f32": "quant_matmul_tile",
           "amq_qmm_grouped_f32": "quant_matmul_f32"}


@functools.lru_cache(maxsize=None)
def _lib(entry: str = "amq_qmm"):
    """An entry point of ``csrc/quant_matmul.cu`` (``amq_qmm``, the grouped
    ``amq_qmm_grouped``), the pipelined grouped ``amq_qmm_pipe`` of
    ``csrc/quant_matmul_pipe.cu``, the tile kernel's ``amq_qmm_tile`` and
    ``amq_qmm_tile_f32`` of ``csrc/quant_matmul_tile.cu`` or the float32
    GEMV's ``amq_qmm_grouped_f32`` of ``csrc/quant_matmul_f32.cu``; all
    take the same arguments (``amq_qmm_tile_f32`` also the split pass's
    chunk sums)."""
    fn = getattr(_cuda.library(_SOURCE.get(entry, "quant_matmul")), entry)
    fn.argtypes = ([_c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,
                    _c_ptr, _c_int, _c_ptr] + [_c_int] * 11
                   + ([_c_ptr] if entry == "amq_qmm_tile_f32" else [])
                   + [_c_ptr])
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _split_lib():
    fn = _cuda.library("quant_matmul_f32").amq_split_f32
    fn.argtypes = [_c_ptr, _c_ptr] + [_c_int] * 4 + [_c_ptr] * 2 + [_c_int] * 2 + [_c_ptr]
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _swiglu_lib():
    fn = _cuda.library("quant_matmul_tile").amq_swiglu_bf16
    fn.argtypes = [_c_ptr] * 3 + [_c_int] * 3 + [_c_ptr]
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _mlp_lib():
    fn = _cuda.library("quant_matmul_mlp").amq_qmm_mlp
    fn.argtypes = ([_c_ptr, _c_int, _c_int, _c_int, _c_int]
                   + [_c_ptr] * 6 + [_c_int] * 15 + [_c_ptr] * 4
                   + [_c_int, _c_ptr])
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(M: int, N: int, n_sb: int, device) -> tuple:
    """(splits, superblocks per split) of the K axis: whole superblocks
    per split, enough blocks for about two per SM (64-column tiles; the
    prefill GEMM also tiles M by 64)."""
    blocks = -(-N // 64) * (1 if M <= 8 else -(-M // 64))
    want = max(1, min(n_sb, -(-2 * _sm_count(device.index or 0) // blocks)))
    per = -(-n_sb // want)
    return -(-n_sb // per), per


#: the grouped GEMV's ring (``qmm_tile.cuh``'s defaults): columns per
#: block, and word rows of a round plane per ring stage (3-bit: half as
#: many 1-bit rows, each with two 2-bit rows)
_GROUPED_BN, _GROUPED_ROWS = 256, 32


def _grouped_round_rows(nbits: int, superblock: int) -> int:
    """Word rows per superblock of the grouped GEMV's round plane (3-bit:
    its 1-bit plane)."""
    return superblock // 32 if nbits == 3 else superblock * nbits // 32


def _grouped_stage_rows(nbits: int, rows: int = _GROUPED_ROWS) -> int:
    """Word rows of the round plane per ring stage of ``rows`` rows."""
    return rows // 2 if nbits == 3 and rows >= 16 else rows


def _grouped_whole_stages(nbits: int, superblock: int,
                          rows: int = _GROUPED_ROWS) -> bool:
    """Does a superblock hold whole ring stages (``grouped_whole_stages``
    in ``csrc/qmm_tile.cuh``)?  The layouts of the ring's whole-stage
    kernel, the only ones the pipelined GEMV and the one-launch MLP take;
    the grouped GEMV fills a stage with several smaller superblocks."""
    return (_grouped_round_rows(nbits, superblock)
            % _grouped_stage_rows(nbits, rows) == 0)


def _grouped_stages(nbits: int, superblock: int, Kp: int,
                    rows: int = _GROUPED_ROWS) -> int:
    """Ring stages of the grouped GEMV over K: Rg / n per superblock where
    a superblock holds whole stages, else one per n / Rg superblocks (a
    spanning stage), the last one holding the rest (Rg: the round plane's
    word rows per superblock, n: per stage)."""
    n_sb, n = Kp // superblock, _grouped_stage_rows(nbits, rows)
    return -(-n_sb * _grouped_round_rows(nbits, superblock) // n)


@functools.lru_cache(maxsize=None)
def _grouped_blocks(nbits: int, swiglu: bool, meta_bf16: int,
                    group_size: int, superblock: int, index: int) -> int:
    """Blocks of the grouped GEMV one SM holds (the CUDA occupancy
    calculator, at its registers and the shared memory of an M = 8 call:
    the split rule then gives every M the same splits, so row m of a call
    has the same bits at any M)."""
    fn = _cuda.library("quant_matmul").amq_qmm_grouped_blocks
    fn.argtypes = [_c_int] * 6
    fn.restype = _c_int
    with torch.cuda.device(index):
        n = fn(nbits, 8, int(swiglu), meta_bf16, group_size, superblock)
    if n < 1:
        raise RuntimeError(f"grouped GEMV ({nbits}-bit): no block fits an "
                           f"SM ({n})")
    return n


def _grouped_splits(N: int, nbits: int, superblock: int, Kp: int,
                    blocks: int, device, rows: int = _GROUPED_ROWS,
                    bn: int = _GROUPED_BN) -> tuple:
    """(splits, ring stages per split) for the grouped GEMV: as many splits
    as fit ``blocks`` blocks per SM in one wave (a second, partial wave
    would cost a whole block's time).  The 1/2/3/4-bit kernels correct at
    every stage, so a split may end at any stage (a spanning one too); the
    8-bit one corrects at group ends and splits at superblocks.  ``rows``
    and ``bn`` are the ring's shape (``probes/grouped_ring.py`` sweeps
    others)."""
    unit = (_grouped_round_rows(nbits, superblock)
            // _grouped_stage_rows(nbits, rows) if nbits == 8 else 1)
    units = _grouped_stages(nbits, superblock, Kp, rows) // unit
    tiles = -(-N // bn)
    want = max(1, min(units, blocks * _sm_count(device.index or 0) // tiles))
    per = -(-units // want)
    return -(-units // per), per * unit


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


@functools.lru_cache(maxsize=None)
def _grouped_layout(nbits: int, group_size: int, superblock: int) -> bool:
    """The weight layouts the grouped GEMV takes (``grouped_takes`` in
    ``csrc/qmm_grouped.cuh`` refuses the rest): groups of a multiple of 64
    rows, a superblock of at most 1024 rows holding whole groups; at 8 bits
    extraction rounds that nest with the groups and whole ring stages (a
    superblock of a multiple of 128 rows); below it power-of-two groups and
    a power-of-two superblock of 128 rows or more -- whole stages (256 rows
    at 4 bits, 512 at 3 and 2, 1024 at 1) or, smaller, several superblocks
    to a stage (the spanning kernel)."""
    if nbits not in (1, 2, 3, 4, 8) or not (
            group_size % (2 * _GROUPED_ROWS) == 0
            and superblock % group_size == 0 and superblock <= 1024):
        return False
    if nbits == 8:
        half = superblock // 2          # an 8-bit round's K rows
        return ((half % group_size == 0 or group_size % half == 0)
                and _grouped_whole_stages(nbits, superblock))
    return _pow2(group_size) and _pow2(superblock) and superblock >= 128


def _grouped_applies(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, nbits: int,
                     group_size: int, superblock: int, up=None) -> bool:
    """Take the grouped tensor-core GEMV?  The JAX package takes its
    grouped serving GEMV at ``single_m and acc_dtype == bf16`` (M <= 8,
    bf16 activations) for every width; the port does too, wherever the
    kernel's own conditions hold: a layout :func:`_grouped_layout` takes,
    a padded N, K and x's row stride that are multiples of 8, and 16-byte
    aligned activations and weights (16-byte bulk copies).  With f32
    activations (the JAX package's f32 function) the ring's float32 form
    takes the same calls.  Other calls take the CUDA-core GEMV; this is
    the only predicate that routes."""
    return (1 <= x.shape[0] <= 8
            and x.dtype in (torch.bfloat16, torch.float32)
            and _grouped_layout(nbits, group_size, superblock)
            and packed.shape[-1] % 8 == 0 and x.shape[-1] % 8 == 0
            and x.stride(0) % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, packed, scale, zero)
                    + ((up,) if up is not None else ())))


@functools.lru_cache(maxsize=None)
def _grouped_plan(N: int, Kp: int, nbits: int, swiglu: bool, meta_bf16: int,
                  group_size: int, superblock: int, index: int) -> tuple:
    """(splits, ring stages per split) of a grouped call, once per weight
    shape and card (the decode loop repeats a few shapes)."""
    blocks = _grouped_blocks(nbits, swiglu, meta_bf16, group_size,
                             superblock, index)
    return _grouped_splits(N, nbits, superblock, Kp, blocks,
                           torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _grouped_f32_plan(N: int, Kp: int, nbits: int, meta_bf16: int,
                      group_size: int, superblock: int, index: int) -> tuple:
    """... of a float32 grouped call: the bf16 GEMV's split rule at the
    blocks per SM of the float32 GEMV's M = 2 form (so every M splits
    alike; above M = 2 its blocks take two waves)."""
    fn = _cuda.library("quant_matmul_f32").amq_qmm_grouped_f32_blocks
    fn.argtypes = [_c_int] * 4
    fn.restype = _c_int
    with torch.cuda.device(index):
        blocks = fn(nbits, meta_bf16, group_size, superblock)
    if blocks < 1:
        raise RuntimeError(f"float32 grouped GEMV ({nbits}-bit): no block "
                           f"fits an SM ({blocks})")
    return _grouped_splits(N, nbits, superblock, Kp, blocks,
                           torch.device("cuda", index))


def _pipe_applies(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor, zero: torch.Tensor, nbits: int,
                  group_size: int, superblock: int, up=None) -> bool:
    """Take the pipelined grouped GEMV?  The JAX package's conditions for
    its pipelined decode GEMV -- the switch is on, M <= 8, bf16
    activations, T = superblock / group >= 8 and a width other than 8 --
    and the grouped ring's own (:func:`_grouped_applies`: its layouts,
    strides and alignment).  The one predicate that routes: a call the
    switch selects but the ring does not take goes where the wrapper sends
    it without the switch."""
    return (bool(_PIPE_DEFAULT) and nbits != 8 and x.dtype == torch.bfloat16
            and superblock // group_size >= 8
            and _grouped_whole_stages(nbits, superblock)
            and _grouped_applies(x, packed, scale, zero, nbits, group_size,
                                 superblock, up))


def _mlp_applies(x: torch.Tensor, gu, dn, nbits: int, group_size: int,
                 superblock: int) -> bool:
    """Does the one-launch MLP take this call?  Its gateup is a grouped
    call on x and its down one on a bf16 [M, Kp_d] activation of its own,
    so x must be bf16 and both stacks' layers (``(packed, scale, zero)``)
    ones the grouped ring takes in whole stages
    (:func:`_grouped_whole_stages`, :func:`_grouped_applies`, which also
    holds x to M <= 8 and its strides and alignment); and, on a card, each
    product's 256-column tiles must fit one wave of the grouped GEMV's
    blocks (the kernel runs one block per item of the larger product, all
    resident at once, and the grouped plan's splits then fit too)."""
    if not (_grouped_whole_stages(nbits, superblock)
            and x.dtype == torch.bfloat16
            and _grouped_applies(x, *gu, nbits, group_size, superblock)
            and dn[0].shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in dn)):
        return False
    if x.device.type != "cuda":
        return True
    index = x.device.index or 0
    meta_bf16 = int(gu[1].dtype == torch.bfloat16)
    return all(-(-t[0].shape[-1] // _GROUPED_BN)
               <= _sm_count(index) * _grouped_blocks(
                   nbits, swiglu, meta_bf16, group_size, superblock, index)
               for t, swiglu in ((gu, False), (dn, True)))


#: the tile kernel's shape (``csrc/quant_matmul_tile.cu``): a block's
#: shared memory, its barriers and alignment, (M sub-tiles, columns) of
#: its block shapes (M <= 64: three warpgroups, M <= 128: two, above:
#: one; the float32 form takes the first at every M), bytes of an x chunk
#: per M sub-tile (the float32 form: three parts and 1 KB of x sums)
_TILE_SMEM, _TILE_HEAD = 232448, 2048
_TILE_BLOCKS, _TILE_XSUB = ((1, 192), (2, 128), (4, 64)), 64 * 128


def _tile_x_bytes(sub: int, exact: bool) -> int:
    return 3 * sub * _TILE_XSUB + 1024 if exact else sub * _TILE_XSUB


#: the tile kernel's pair form (4-row superblocks): word rows per stage
_TILE_PAIR_NS = 16


def _pair_layout(nbits: int, superblock: int) -> bool:
    """A 4-row superblock (1 and 3 bits at 128 rows: the round plane has 4
    word rows): the pair forms of the tile kernel and the grouped ring,
    whose k16 / 8-row steps take one superblock's two rounds."""
    return nbits in (1, 3) and superblock == 128


@functools.lru_cache(maxsize=None)
def _tile_ns(nbits: int, group_size: int, superblock: int,
             meta_bf16: int, exact: bool = False) -> int:
    """Word rows per ring stage of the tile kernel at a weight layout, or
    0 for a layout it does not take (``tile_ns`` in
    ``csrc/quant_matmul_tile.cu``): widths 1/2/3/4/8, a superblock of a
    multiple of 64 rows, at most 1024, holding whole groups of a multiple
    of 16 rows; then the largest of 32, 16, 8 that divides the round
    plane's word rows (every 16-row wgmma step in one extraction round:
    1-bit and 3-bit superblocks of a multiple of 256 rows, 2-bit of 128),
    whose chunks of 2 ns K rows lie in one group or hold whole ones, and
    whose ring (two word stages with their meta, two x chunks) fits a
    block's shared memory at every block shape.  The 4-row superblocks
    (:func:`_pair_layout`) take the pair form's 16 rows (four superblocks
    a stage, a 16-row step two rounds of one), at groups of a multiple of
    32 rows (chunks of 32 K rows in one group).  ``exact``, the float32
    form (``tile_ns_exact``): 16 or 8 rows, chunks inside one group, and
    the ring of its x slots at one M sub-tile (its only block shape)."""
    if (nbits not in (1, 2, 3, 4, 8) or superblock % 64 or superblock > 1024
            or group_size < 16 or group_size % 16
            or superblock % group_size):
        return 0
    R = superblock // 32 if nbits == 3 else superblock * nbits // 32
    P = 16 if nbits == 3 else 16 // nbits
    es = 2 if meta_bf16 else 4
    blocks = _TILE_BLOCKS[:1] if exact else _TILE_BLOCKS
    pair = _pair_layout(nbits, superblock)
    for ns in ((16, 8) if exact else (32, 16, 8)):
        if pair:
            if ns != _TILE_PAIR_NS or group_size % (2 * ns):
                continue
        elif R % ns or not (group_size % (2 * ns) == 0 or not exact
                            and (2 * ns) % group_size == 0):
            continue
        Q = max(1, 2 * ns // group_size)
        if all(_TILE_SMEM - _TILE_HEAD
               - 2 * ((3 if nbits == 3 else 1) * ns * (bn + 8) * 4
                      + P * Q * 2 * bn * es) >= 2 * _tile_x_bytes(sub, exact)
               for sub, bn in blocks):
            return ns
    return 0


def _tile_applies(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor, zero: torch.Tensor, nbits: int,
                  group_size: int, superblock: int, up=None) -> bool:
    """Take the tile kernel on wgmma?  The JAX package dequantizes each
    weight tile once, in bf16, for its multi-row calls with bf16
    activations (8 < M, ``acc_dtype == bf16``); the port does too,
    wherever the kernel's own conditions hold: a layout
    :func:`_tile_ns` takes, a padded N, K and x's row stride that are
    multiples of 8, and 16-byte aligned activations and weights (16-byte
    copies).  With f32 activations the tile kernel's float32 form takes
    the layouts ``_tile_ns(..., exact=True)`` takes.  Other calls with
    8 < M take the CUDA-core GEMM; this is the only predicate that routes
    them."""
    return (x.shape[0] > 8 and x.dtype in (torch.bfloat16, torch.float32)
            and _tile_ns(nbits, group_size, superblock,
                         int(scale.dtype == torch.bfloat16),
                         x.dtype == torch.float32) > 0
            and packed.shape[-1] % 8 == 0 and x.shape[-1] % 8 == 0
            and x.stride(0) % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, packed, scale, zero)
                    + ((up,) if up is not None else ())))


@functools.lru_cache(maxsize=None)
def _tile_plan(N: int, Kp: int, nbits: int, group_size: int,
               superblock: int, meta_bf16: int, index: int,
               exact: bool = False) -> tuple:
    """(splits, ring stages per split) of a tile call (``exact``: of its
    float32 form).  The K splits are
    reckoned for the M <= 64 block (192 columns, one an SM): of up to
    three blocks an SM's worth of splits, the fewest whose waves of
    blocks times stages per split is least (a split's blocks run in
    parallel, its stages in turn).  They depend on the weight's shape and
    layout and the card, never on M, so that row m of a call has the same
    bits at any M."""
    R = superblock // 32 if nbits == 3 else superblock * nbits // 32
    ns = _tile_ns(nbits, group_size, superblock, meta_bf16, exact)
    units = -(-Kp // superblock * R // ns)        # ring stages of K
    sms = _sm_count(index)
    tiles = -(-N // _TILE_BLOCKS[0][1])
    cap = max(1, min(units, -(-3 * sms // tiles)))
    best = min(range(1, cap + 1),
               key=lambda s: (-(-tiles * s // sms) * -(-units // s), s))
    per = -(-units // best)
    return -(-units // per), per


# ---------------------------------------------------------------------------
# plain versions (the CPU path; also the reference the kernels are held to)

def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in float32, rounded to the input type."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def qmm_plain(x, packed, scale, zero, *, nbits, group_size, shape,
              superblock, out_dtype, up=None) -> torch.Tensor:
    """x [M, K] @ dequant(packed) (float32 dequantization and product) ->
    [M, N]; with ``up`` the activation is ``silu(x) * up``."""
    if up is not None:
        x = swiglu_plain(x, up)
    qt = QuantizedTensor(packed=packed, scale=scale, zero=zero, nbits=nbits,
                         group_size=group_size, shape=tuple(shape),
                         superblock=superblock)
    return torch.matmul(x.float(), dequantize_kn(qt, torch.float32)).to(out_dtype)


def qmm_tile_plain(x, packed, scale, zero, *, nbits, group_size, shape,
                   superblock, out_dtype, up=None) -> torch.Tensor:
    """The JAX package's bf16 multi-row form (``_dequant_tile`` at
    ``acc_dtype = bf16``, then the dot): x rounded to bf16 (with ``up``,
    ``silu(x) * up`` in f32, rounded to bf16); the weight dequantized as
    the reference does -- widths 1-4 in bf16, rounding after each
    operation, ``(c - z) * s`` with the meta rounded to bf16 first (3-bit
    codes recombined exactly); 8 bits ``(c - z) * s`` in f32, rounded to
    bf16 once -- then a float32 product, rounded once to ``out_dtype``.
    The reference of the tile kernel, and the CPU route of bf16 calls
    with 8 < M."""
    if up is not None:
        x = swiglu_plain(x, up)
    N, K = shape
    codes = bitpack.unpack(packed, nbits, superblock)        # [Kp, Np]
    rep = functools.partial(torch.repeat_interleave, repeats=group_size,
                            dim=0)
    if nbits == 8:
        w = ((codes.float() - rep(zero.float())) * rep(scale.float())
             ).to(torch.bfloat16)
    else:
        w = ((codes.to(torch.bfloat16) - rep(zero.to(torch.bfloat16)))
             * rep(scale.to(torch.bfloat16)))
    return torch.matmul(x.to(torch.bfloat16).float(),
                        w[:K, :N].float()).to(out_dtype)


def qmm_grouped_plain(x, packed, scale, zero, *, nbits, group_size, shape,
                      superblock, out_dtype, up=None) -> torch.Tensor:
    """The grouped form of the JAX package's serving GEMV
    (``_gemv_blockdiag``): per group g of ``group_size`` K rows and column
    n, over the bf16 activations (products exact, f32 sums),
    ``y_g = sum x (128 + c)`` at 1/2/3/4 bits (one plane, 3-bit codes
    recombined; offset 128), ``16 * sum x (128 + hi) + sum x (128 + lo)``
    at 8 bits (two nibble planes; offset 2176), then
    ``out = sum_g s_g * y_g - xsum_g * (z_g + offset) * s_g`` with
    ``xsum_g`` the f32 sum of the same bf16 activations.  The reference of
    the grouped CUDA GEMV; with ``up`` the activation is ``silu(x) * up``."""
    if nbits not in (1, 2, 3, 4, 8):
        raise ValueError(f"no grouped form for {nbits}-bit")
    if up is not None:
        x = swiglu_plain(x, up)
    N, K = shape
    codes = bitpack.unpack(packed, nbits, superblock)        # [Kp, Np]
    Kp, Np = codes.shape
    G, g = Kp // group_size, group_size
    xb = F.pad(x.to(torch.bfloat16).float(), (0, Kp - K)).reshape(-1, G, g)
    if nbits == 8:      # nibble planes weighted 16 and 1 (hi, lo)
        planes = [(16.0, (codes >> 4) & 15), (1.0, codes & 15)]
        zoff = 17 * 128.0
    else:
        planes, zoff = [(1.0, codes)], 128.0
    y = sum(w * torch.einsum("mgk,gkn->gmn", xb,
                             c.float().add_(128.0).reshape(G, g, Np))
            for w, c in planes)                               # [G, M, Np]
    xsum = xb.sum(dim=2).T[:, :, None]                        # [G, M, 1]
    s = scale.float().reshape(G, 1, Np)
    corr = (zero.float().reshape(G, 1, Np) + zoff) * s
    out = (s * y - xsum * corr).sum(dim=0)
    return out[:, :N].to(out_dtype)


def split_f32_plain(x: torch.Tensor, parts: int = 3) -> torch.Tensor:
    """The split pass's parts of f32 x: ``[parts, *x.shape]`` f32 holding
    bf16 values, part q the bf16 rounding of what parts 0 .. q-1 left
    (each difference exact in f32; three hold x's 24 bits)."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return torch.stack(out)


def qmm_exact_plain(x, packed, scale, zero, *, nbits, group_size, shape,
                    superblock, out_dtype, up=None, parts=3,
                    piece=None) -> torch.Tensor:
    """The float32 form of the grouped GEMV and the tile kernel (f32
    activations): x (with ``up``, ``silu(x) * up`` in f32) split into
    ``parts`` bf16 parts (:func:`split_f32_plain`); per piece of
    ``piece`` K rows (default a group; the GEMV corrects per 64-row round
    of a ring stage, the tile kernel per chunk of 2 ns rows) and column n,
    ``y = sum_q sum_k c_k part_q,k`` (exact codes: products exact, f32
    sums) and ``xsum = sum_q sum_k part_q,k``, then
    ``out = sum_pieces s y - (z s) xsum`` with the piece's group's scale
    and zero, in piece order.  Three parts compute the JAX package's f32
    function (:func:`qmm_plain`) to f32 rounding; the arithmetic the two
    kernels run, held to the JAX package's f32 functions by
    ``tests/test_torch_qmm_f32.py``."""
    if up is not None:
        x = swiglu_plain(x, up)
    N, K = shape
    codes = bitpack.unpack(packed, nbits, superblock)        # [Kp, Np]
    Kp, Np = codes.shape
    piece = piece or group_size
    G, per = Kp // piece, group_size // piece
    xp = F.pad(split_f32_plain(x, parts), (0, Kp - K))
    xp = xp.reshape(parts, -1, G, piece)                      # [q, M, G, p]
    c = codes.float().reshape(G, piece, Np)
    y = torch.einsum("qmgk,gkn->gmn", xp, c)                  # [G, M, Np]
    xsum = xp.sum(dim=(0, 3)).T[:, :, None]                   # [G, M, 1]
    rep = functools.partial(torch.repeat_interleave, repeats=per, dim=0)
    s = rep(scale.float()).reshape(G, 1, Np)
    zs = rep(zero.float()).reshape(G, 1, Np) * s
    out = y.new_zeros(y.shape[1:])
    for g in range(G):                                        # piece order
        out = out + (s[g] * y[g] - zs[g] * xsum[g])
    return out[:, :N].to(out_dtype)


def _mlp_chain(gemv, x, gu_packed, gu_scale, gu_zero, d_packed, d_scale,
               d_zero, *, nbits, group_size, gu_shape, d_shape, superblock,
               out_dtype) -> torch.Tensor:
    """``down(swiglu(gateup(x)))`` with ``gemv`` for both products: gateup
    rounded to bf16, ``silu(gate) * up`` rounded to bf16 (zero at or past
    the real intermediate width: the down product reads only the first
    ``inter`` activations), then down."""
    inter = gu_shape[0] // 2
    kw = dict(nbits=nbits, group_size=group_size, superblock=superblock)
    gu = gemv(x, gu_packed, gu_scale, gu_zero, shape=gu_shape,
              out_dtype=torch.bfloat16, **kw)
    act = swiglu_plain(gu[:, :inter], gu[:, inter:2 * inter])
    return gemv(act[:, :d_shape[1]], d_packed, d_scale, d_zero, shape=d_shape,
                out_dtype=out_dtype, **kw)


def qmm_mlp_plain(x, gu_packed, gu_scale, gu_zero, d_packed, d_scale, d_zero,
                  **static) -> torch.Tensor:
    """``down(swiglu(gateup(x)))`` for one layer through :func:`qmm_plain`
    (f32 dequantization and products; the CPU route of
    :func:`quant_matmul_mlp_indexed`)."""
    return _mlp_chain(qmm_plain, x, gu_packed, gu_scale, gu_zero, d_packed,
                      d_scale, d_zero, **static)


def qmm_mlp_grouped_plain(x, gu_packed, gu_scale, gu_zero, d_packed, d_scale,
                          d_zero, **static) -> torch.Tensor:
    """``down(swiglu(gateup(x)))`` for one layer in the grouped form, the
    function of the JAX package's ``_qmm_kernel_mlp`` (``_gemv_blockdiag``
    for both products, gateup kept in a bf16 scratch): gateup through
    :func:`qmm_grouped_plain` rounded to bf16, :func:`swiglu_plain`, down
    through :func:`qmm_grouped_plain`.  The one-launch MLP kernel's
    reference."""
    return _mlp_chain(qmm_grouped_plain, x, gu_packed, gu_scale, gu_zero,
                      d_packed, d_scale, d_zero, **static)


# ---------------------------------------------------------------------------
# kernel launch

def _qmm_cuda(x, up, packed, scale, zero, *, nbits, group_size, shape,
              superblock, out_dtype, pipe=False, cuda_core=False) -> tuple:
    """Launch the kernel; returns (out, route): "grouped", "tile", "pipe"
    or "cuda_core".  ``pipe`` takes the pipelined grouped GEMV (it counts
    on its own wrapper, not as grouped); ``cuda_core`` keeps a call that
    the grouped GEMV or the tile kernel would take on the CUDA-core GEMV
    or GEMM (the probes', tests' and smoke run's pins: the attribution
    probe shares the GEMV's arithmetic, the smoke run times the GEMM
    beside the tile kernel); no public switch reaches it."""
    N, K = shape
    M = x.shape[0]
    rows, Np = packed.shape
    Kp = rows * 32 // nbits
    what = (f"quant_matmul{'_pipe' if pipe else ''} ({nbits}-bit, M={M}, "
            f"N={N}, K={K})")
    if nbits not in ((1, 2, 3, 4) if pipe else (1, 2, 3, 4, 8)):
        raise ValueError(f"{what}: no kernel for {nbits}-bit")
    tensors = [x, packed, scale, zero] + ([up] if up is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if packed.dtype != torch.int32:
        raise TypeError(f"{what}: packed words must be int32, got {packed.dtype}")
    if scale.dtype != zero.dtype:
        raise TypeError(f"{what}: scale {scale.dtype} vs zero {zero.dtype}")
    if x.dim() != 2 or x.shape[1] != K or x.stride(1) != 1:
        raise ValueError(f"{what}: x must be [M, K] with unit column stride, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    if up is not None and (up.shape != x.shape or up.stride() != x.stride()
                           or up.dtype != x.dtype):
        raise ValueError(f"{what}: up must match gate in shape, strides, dtype")
    if not (packed.is_contiguous() and scale.is_contiguous()
            and zero.is_contiguous()):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    if (Kp % superblock or superblock % 64 or superblock % group_size
            or superblock > 1024 or K > Kp or N > Np
            or scale.shape != (Kp // group_size, Np) or zero.shape != scale.shape):
        raise ValueError(f"{what}: packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}, superblock {superblock}, "
                         f"group {group_size} do not fit")
    ring = not cuda_core and _grouped_applies(
        x, packed, scale, zero, nbits, group_size, superblock, up)
    tile = not (cuda_core or ring) and _tile_applies(
        x, packed, scale, zero, nbits, group_size, superblock, up)
    if pipe and (not ring or x.dtype != torch.bfloat16):
        raise ValueError(f"{what}: the pipelined GEMV takes bf16 x, M <= 8 "
                         f"and the grouped ring's layouts, strides and "
                         f"alignment")
    meta_bf16 = _cuda.dtype_flag(scale, what)
    index = x.device.index or 0
    exact = (ring or tile) and x.dtype == torch.float32   # the float32 forms
    ldx, extra = x.stride(0), ()
    if ring and exact:
        entry = "amq_qmm_grouped_f32"
        splits, per = _grouped_f32_plan(N, Kp, nbits, meta_bf16, group_size,
                                        superblock, index)
        x, up, ldx = _split_f32(x, up, Kp, 0, what)[0], None, K
    elif ring:
        entry = "amq_qmm_pipe" if pipe else "amq_qmm_grouped"
        splits, per = _grouped_plan(N, Kp, nbits, up is not None, meta_bf16,
                                    group_size, superblock, index)
    elif tile:
        entry = "amq_qmm_tile_f32" if exact else "amq_qmm_tile"
        splits, per = _tile_plan(N, Kp, nbits, group_size, superblock,
                                 meta_bf16, index, exact)
        if exact:             # the parts' x slot image and the x sums
            x, xsc = _split_f32(x, up, Kp, 2 * _tile_ns(
                nbits, group_size, superblock, meta_bf16, True), what)
            up, ldx, extra = None, xsc.shape[1], (_cuda.ptr(xsc),)
        elif up is not None:  # the SwiGLU prologue, once per element
            act = torch.empty((M, K), dtype=torch.bfloat16, device=x.device)
            _cuda.check(_swiglu_lib()(_cuda.ptr(x), _cuda.ptr(up),
                                      _cuda.ptr(act), M, K, x.stride(0),
                                      _cuda.stream()), f"{what} (SwiGLU)")
            x, up, ldx = act, None, K
    else:
        entry = "amq_qmm"
        splits, per = _splits(M, N, Kp // superblock, x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    rc = _lib(entry)(_cuda.ptr(x), _cuda.ptr(up), _cuda.dtype_flag(x, what),
                     _cuda.ptr(packed), _cuda.ptr(scale), _cuda.ptr(zero),
                     meta_bf16, _cuda.ptr(out),
                     _cuda.dtype_flag(out, what), _cuda.ptr(partial),
                     M, K, ldx, Kp, N, Np, nbits, group_size,
                     superblock, splits, per, *extra, _cuda.stream())
    _cuda.check(rc, what)
    route = ("pipe" if pipe else "grouped") if ring else (
        "tile" if tile else "cuda_core")
    return out, route


def _split_f32(x, up, Kp: int, chunk: int, what: str) -> tuple:
    """The split pass on f32 x [M, K] (with ``up``, ``silu(x) * up``) into
    three bf16 parts: for the grouped GEMV (``chunk`` 0) [M, 3, K] (rows
    3m + q, row stride K) and None; for the tile kernel (``chunk`` its
    2 ns) its x slot image [Kp / chunk, 3, mpad, 64] (mpad: M rounded up
    to the 64-row M tile) and the f32 x sums of each chunk of K rows
    [Kp / chunk, mpad]."""
    M, K = x.shape
    if chunk:
        mpad = -(-M // 64) * 64
        parts = torch.empty((Kp // chunk, 3, mpad, 64), dtype=torch.bfloat16,
                            device=x.device)
        sums = torch.empty((Kp // chunk, mpad), dtype=torch.float32,
                           device=x.device)
    else:
        mpad, sums = 0, None
        parts = torch.empty((M, 3, K), dtype=torch.bfloat16, device=x.device)
    _cuda.check(_split_lib()(_cuda.ptr(x), _cuda.ptr(up), M, K, x.stride(0),
                             Kp, _cuda.ptr(parts), _cuda.ptr(sums), chunk,
                             mpad, _cuda.stream()), f"{what} (split)")
    return parts, sums


def _plain(x, packed, scale, zero, *, out_dtype, up=None, **static):
    """The CPU route: the reference's bf16 multi-row form for bf16 x with
    8 < M (:func:`qmm_tile_plain`), else :func:`qmm_plain`."""
    fn = (qmm_tile_plain if x.dtype == torch.bfloat16 and x.shape[0] > 8
          else qmm_plain)
    return fn(x, packed, scale, zero, out_dtype=out_dtype, up=up, **static)


def _qmm(x, up, packed, scale, zero, *, out_dtype, counter, pipe=False,
         **static):
    if x.device.type == "cpu":
        return _plain(x, packed, scale, zero, out_dtype=out_dtype, up=up,
                      **static)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out, route = _qmm_cuda(x, up, packed, scale, zero, out_dtype=out_dtype,
                           pipe=pipe, **static)
    counter.launches += 1
    pair = _pair_layout(static["nbits"], static["superblock"])
    if route == "grouped":
        counter.grouped_launches += 1
        if not _grouped_whole_stages(static["nbits"], static["superblock"]):
            counter.span_launches += 1
        counter.pair_launches += pair
    elif route == "tile":
        counter.tile_launches += 1
        counter.pair_tile_launches += pair
    return out


def _qmm_cuda_core(x, packed, scale, zero, *, out_dtype, up=None,
                  **static) -> torch.Tensor:
    """One layer's dequant-matmul on the CUDA-core GEMV (M <= 8) or GEMM
    (8 < M), even where the grouped GEMV or the tile kernel would take the
    call: the route that the attribution probe's ``full`` (both bodies)
    gives the same bits as (its ``torch.equal`` pin), and the GEMM the
    smoke run times beside the tile kernel.  :func:`qmm_plain` on the CPU
    (the CUDA-core routes' f32 function).  Counts no launch."""
    if x.device.type == "cpu":
        return qmm_plain(x, packed, scale, zero, out_dtype=out_dtype, up=up,
                         **static)
    return _qmm_cuda(x, up, packed, scale, zero, out_dtype=out_dtype,
                     cuda_core=True, **static)[0]


# ---------------------------------------------------------------------------
# public API

def quant_matmul_indexed(x: torch.Tensor, packed_stack: torch.Tensor,
                         scale_stack: torch.Tensor, zero_stack: torch.Tensor,
                         layer: int, *, nbits: int, group_size: int, shape,
                         superblock: int, out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ dequant(packed_stack[layer])`` -> ``[M, N]``.

    Replaces ``quant_matmul_indexed`` (kernel ``_qmm_kernel_stacked``) of
    the JAX package's ``ops/quant_matmul.py``.  ``layer`` is a host int
    (the layer loop runs in Python); ``packed_stack[layer]`` is a view.
    Where the JAX package takes its pipelined branch and the grouped ring
    takes the call (:func:`_pipe_applies`), this goes to
    :func:`quant_matmul_indexed_pipe`.
    """
    packed, scale, zero = (packed_stack[layer], scale_stack[layer],
                           zero_stack[layer])
    if _pipe_applies(x, packed, scale, zero, nbits, group_size, superblock):
        return quant_matmul_indexed_pipe(
            x, packed_stack, scale_stack, zero_stack, layer, nbits=nbits,
            group_size=group_size, shape=shape, superblock=superblock,
            out_dtype=out_dtype)
    return _qmm(x, None, packed, scale, zero, nbits=nbits,
                group_size=group_size, shape=tuple(shape),
                superblock=superblock, out_dtype=out_dtype or x.dtype,
                counter=quant_matmul_indexed)


quant_matmul_indexed.launches = 0
#: launches that took the grouped tensor-core GEMV (M <= 8; its float32
#: form for f32 x)
quant_matmul_indexed.grouped_launches = 0
#: ... of them at a layout whose superblocks span a ring stage
quant_matmul_indexed.span_launches = 0
#: launches that took the tile kernel on wgmma (8 < M; its float32 form
#: for f32 x)
quant_matmul_indexed.tile_launches = 0
#: grouped and tile launches at 4-row superblocks (the pair forms)
quant_matmul_indexed.pair_launches = 0
quant_matmul_indexed.pair_tile_launches = 0


def quant_matmul_indexed_pipe(x: torch.Tensor, packed_stack: torch.Tensor,
                              scale_stack: torch.Tensor,
                              zero_stack: torch.Tensor, layer: int, *,
                              nbits: int, group_size: int, shape,
                              superblock: int, out_dtype=None) -> torch.Tensor:
    """:func:`quant_matmul_indexed` through the software-pipelined grouped
    GEMV, whatever the switch says (bf16 x, M <= 8, widths 1-4, a call
    the grouped ring takes; others raise).

    Replaces the pipelined branch of ``quant_matmul_indexed`` (kernel
    ``_qmm_kernel_stacked_pipe``) of the JAX package's
    ``ops/quant_matmul.py``.  On a CUDA tensor it computes the grouped
    form (reference :func:`qmm_grouped_plain`; the grouped GEMV's bits);
    on the CPU it takes :func:`qmm_plain`, as the JAX package's CPU
    backend takes no kernel.
    """
    return _qmm(x, None, packed_stack[layer], scale_stack[layer],
                zero_stack[layer], nbits=nbits, group_size=group_size,
                shape=tuple(shape), superblock=superblock,
                out_dtype=out_dtype or x.dtype, pipe=True,
                counter=quant_matmul_indexed_pipe)


quant_matmul_indexed_pipe.launches = 0


def quant_matmul_swiglu_indexed(gate: torch.Tensor, up: torch.Tensor,
                                packed_stack: torch.Tensor,
                                scale_stack: torch.Tensor,
                                zero_stack: torch.Tensor, layer: int, *,
                                nbits: int, group_size: int, shape,
                                superblock: int, out_dtype=None) -> torch.Tensor:
    """``silu(gate) * up @ dequant(packed_stack[layer])`` with the SwiGLU
    computed in the kernel's prologue (f32, rounded to the input type).

    Replaces ``quant_matmul_swiglu_indexed`` (kernel ``_qmm_kernel_swiglu``)
    of the JAX package's ``ops/quant_matmul.py``; where the JAX package
    takes its pipelined branch and the grouped ring takes the call
    (:func:`_pipe_applies`), this goes to
    :func:`quant_matmul_swiglu_indexed_pipe`.
    """
    packed, scale, zero = (packed_stack[layer], scale_stack[layer],
                           zero_stack[layer])
    if _pipe_applies(gate, packed, scale, zero, nbits, group_size, superblock,
                     up):
        return quant_matmul_swiglu_indexed_pipe(
            gate, up, packed_stack, scale_stack, zero_stack, layer,
            nbits=nbits, group_size=group_size, shape=shape,
            superblock=superblock, out_dtype=out_dtype)
    return _qmm(gate, up, packed, scale, zero, nbits=nbits,
                group_size=group_size, shape=tuple(shape),
                superblock=superblock, out_dtype=out_dtype or gate.dtype,
                counter=quant_matmul_swiglu_indexed)


quant_matmul_swiglu_indexed.launches = 0
#: launches that took the grouped tensor-core GEMV (M <= 8; its float32
#: form for f32 x)
quant_matmul_swiglu_indexed.grouped_launches = 0
#: ... of them at a layout whose superblocks span a ring stage
quant_matmul_swiglu_indexed.span_launches = 0
#: launches that took the tile kernel on wgmma (8 < M; its float32 form
#: for f32 x)
quant_matmul_swiglu_indexed.tile_launches = 0
#: grouped and tile launches at 4-row superblocks (the pair forms)
quant_matmul_swiglu_indexed.pair_launches = 0
quant_matmul_swiglu_indexed.pair_tile_launches = 0


def quant_matmul_swiglu_indexed_pipe(gate: torch.Tensor, up: torch.Tensor,
                                     packed_stack: torch.Tensor,
                                     scale_stack: torch.Tensor,
                                     zero_stack: torch.Tensor, layer: int, *,
                                     nbits: int, group_size: int, shape,
                                     superblock: int,
                                     out_dtype=None) -> torch.Tensor:
    """:func:`quant_matmul_swiglu_indexed` through the software-pipelined
    grouped GEMV, whatever the switch says (as
    :func:`quant_matmul_indexed_pipe`).

    Replaces the pipelined branch of ``quant_matmul_swiglu_indexed``
    (kernel ``_qmm_kernel_swiglu_pipe``) of the JAX package's
    ``ops/quant_matmul.py``.  Its reference on a CUDA tensor is
    :func:`qmm_grouped_plain`; the CPU takes :func:`qmm_plain`.
    """
    return _qmm(gate, up, packed_stack[layer], scale_stack[layer],
                zero_stack[layer], nbits=nbits, group_size=group_size,
                shape=tuple(shape), superblock=superblock,
                out_dtype=out_dtype or gate.dtype, pipe=True,
                counter=quant_matmul_swiglu_indexed_pipe)


quant_matmul_swiglu_indexed_pipe.launches = 0


def quant_matmul_mlp_indexed(x: torch.Tensor, gu_packed: torch.Tensor,
                             gu_scale: torch.Tensor, gu_zero: torch.Tensor,
                             d_packed: torch.Tensor, d_scale: torch.Tensor,
                             d_zero: torch.Tensor, layer: int, *, nbits: int,
                             group_size: int, gu_shape, d_shape,
                             superblock: int,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """``down(swiglu(gateup(x)))`` for layer ``layer`` of the stacked
    gateup and down weights, in one launch.  x: [M <= 8, K_gu] -> [M, N_d].

    Replaces ``quant_matmul_mlp_indexed`` (kernel ``_qmm_kernel_mlp``) of
    the JAX package's ``ops/quant_matmul.py``.  ``gu_shape`` is the logical
    ``([gate; up], hidden)``, ``d_shape`` ``(hidden, inter)``.  On a CUDA
    tensor it computes the grouped form (reference
    :func:`qmm_mlp_grouped_plain`; the bits of the separate grouped
    gateup -> SwiGLU-down chain) for the calls :func:`_mlp_applies` takes,
    and raises on others; on the CPU it takes :func:`qmm_mlp_plain`.  A
    refused cooperative launch raises; nothing falls back to the separate
    kernels.
    """
    static = dict(nbits=nbits, group_size=group_size, gu_shape=tuple(gu_shape),
                  d_shape=tuple(d_shape), superblock=superblock,
                  out_dtype=out_dtype)
    gu = (gu_packed[layer], gu_scale[layer], gu_zero[layer])
    dn = (d_packed[layer], d_scale[layer], d_zero[layer])
    if x.device.type == "cpu":
        return qmm_mlp_plain(x, *gu, *dn, **static)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _mlp_cuda(x, gu, dn, **static)
    quant_matmul_mlp_indexed.launches += 1
    return out


quant_matmul_mlp_indexed.launches = 0


def _mlp_cuda(x, gu, dn, *, nbits, group_size, gu_shape, d_shape, superblock,
              out_dtype) -> torch.Tensor:
    (N_gu, K_gu), (N_d, K_d) = gu_shape, d_shape
    M = x.shape[0]
    inter = N_gu // 2
    what = (f"quant_matmul_mlp ({nbits}-bit, M={M}, gateup {N_gu}x{K_gu}, "
            f"down {N_d}x{K_d})")
    if nbits not in (1, 2, 3, 4, 8):
        raise ValueError(f"{what}: no kernel for {nbits}-bit")
    tensors = [x, *gu, *dn]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if any(t.dtype != torch.int32 for t in (gu[0], dn[0])):
        raise TypeError(f"{what}: packed words must be int32")
    if len({t.dtype for t in (*gu[1:], *dn[1:])}) != 1:
        raise TypeError(f"{what}: scale/zero dtypes of both stacks must agree")
    if not 1 <= M <= 8 or x.dim() != 2 or x.shape[1] != K_gu or x.stride(1) != 1:
        raise ValueError(f"{what}: x must be [M <= 8, K] with unit column "
                         f"stride, got {tuple(x.shape)}")
    if N_gu % 2 or K_d != inter:
        raise ValueError(f"{what}: gateup must be [gate; up] of the down "
                         f"projection's input width")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    Kp_gu = gu[0].shape[0] * 32 // nbits
    Kp_d = dn[0].shape[0] * 32 // nbits
    Np_gu, Np_d = gu[0].shape[1], dn[0].shape[1]
    for (packed, scale, zero), Kp, Np, K, N in ((gu, Kp_gu, Np_gu, K_gu, N_gu),
                                                (dn, Kp_d, Np_d, K_d, N_d)):
        if (Kp % superblock or superblock % 64 or superblock % group_size
                or superblock > 1024 or K > Kp or N > Np
                or scale.shape != (Kp // group_size, Np)
                or zero.shape != scale.shape):
            raise ValueError(f"{what}: packed {tuple(packed.shape)}, scale "
                             f"{tuple(scale.shape)}, superblock {superblock}, "
                             f"group {group_size} do not fit")
    if not _mlp_applies(x, gu, dn, nbits, group_size, superblock):
        raise ValueError(f"{what}: the one-launch MLP takes bf16 x and "
                         f"layers the grouped ring takes")
    meta_bf16 = _cuda.dtype_flag(gu[1], what)
    index = x.device.index or 0
    # the separate grouped calls' K splits (down's as the SwiGLU-down
    # call), so the sums run in their order
    s_gu, per_gu = _grouped_plan(N_gu, Kp_gu, nbits, False, meta_bf16,
                                 group_size, superblock, index)
    s_d, per_d = _grouped_plan(N_d, Kp_d, nbits, True, meta_bf16, group_size,
                               superblock, index)
    dev = x.device
    gu_part = torch.empty((s_gu, M, N_gu), dtype=torch.float32, device=dev)
    act = torch.empty((M, Kp_d), dtype=torch.bfloat16, device=dev)
    d_part = (torch.empty((s_d, M, N_d), dtype=torch.float32, device=dev)
              if s_d > 1 else None)
    out = torch.empty((M, N_d), dtype=out_dtype, device=dev)
    ptr = _cuda.ptr
    rc = _mlp_lib()(ptr(x), _cuda.dtype_flag(x, what), M, K_gu, x.stride(0),
                    ptr(gu[0]), ptr(gu[1]), ptr(gu[2]), ptr(dn[0]),
                    ptr(dn[1]), ptr(dn[2]), meta_bf16,
                    Np_gu, Np_d, N_gu, inter, Kp_gu, Kp_d, N_d, nbits,
                    group_size, superblock, s_gu, per_gu, s_d, per_d,
                    ptr(gu_part), ptr(act), ptr(d_part), ptr(out),
                    _cuda.dtype_flag(out, what), _cuda.stream())
    _cuda.check(rc, what)
    return out


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 out_dtype=None) -> torch.Tensor:
    """``x @ W_dequant.T`` with W packed.  x: [..., K] -> [..., N].

    Replaces ``quant_matmul`` (``_quant_matmul_packed``, kernel
    ``_qmm_kernel``) of the JAX package's ``ops/quant_matmul.py``.  5/6-bit
    take :func:`quant_matmul_reference`, as in the JAX package.
    """
    lead = x.shape[:-1]
    K = x.shape[-1]
    assert K == qt.in_features, (tuple(x.shape), qt.shape)
    if qt.nbits not in (1, 2, 3, 4, 8):
        return quant_matmul_reference(x, qt, out_dtype=out_dtype)
    out = _qmm(x.reshape(-1, K), None, qt.packed, qt.scale, qt.zero,
               nbits=qt.nbits, group_size=qt.group_size, shape=tuple(qt.shape),
               superblock=qt.superblock_, out_dtype=out_dtype or x.dtype,
               counter=quant_matmul)
    return out.reshape(*lead, qt.out_features)


quant_matmul.launches = 0
#: launches that took the grouped tensor-core GEMV (M <= 8; its float32
#: form for f32 x)
quant_matmul.grouped_launches = 0
#: ... of them at a layout whose superblocks span a ring stage
quant_matmul.span_launches = 0
#: launches that took the tile kernel on wgmma (8 < M; its float32 form
#: for f32 x)
quant_matmul.tile_launches = 0
#: grouped and tile launches at 4-row superblocks (the pair forms)
quant_matmul.pair_launches = 0
quant_matmul.pair_tile_launches = 0


def quant_matmul_reference(x: torch.Tensor, qt: QuantizedTensor,
                           out_dtype=None) -> torch.Tensor:
    """Dequantize (in x's dtype) then matmul with float32 accumulation --
    the JAX package's non-kernel path."""
    wt = dequantize_kn(qt, dtype=x.dtype)
    out = torch.matmul(x.float(), wt.float())
    return out.to(out_dtype or x.dtype)

