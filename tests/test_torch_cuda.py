"""The port's CUDA kernels held to their plain versions on a card.

Marked ``cuda``: they skip without a card (the kernels have no CPU mode).
This file imports no JAX, so it also runs where only PyTorch is installed
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from amq_tpu_torch.core import quantize as tq
from amq_tpu_torch.ops import decode_attention as tda
from amq_tpu_torch.ops import dequant as tdq
from amq_tpu_torch.ops import quant_matmul as tqm


def _norm_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 3, 64])
def test_cuda_quant_matmul_matches_plain(nbits, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(60 + nbits + M)
    N, K = 320, 1152
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock, out_dtype=torch.float32)
    got = tqm.quant_matmul_swiglu_indexed(x, u, qt.packed[None], qt.scale[None],
                                          qt.zero[None], 0, **kw)
    want = tqm.qmm_plain(x, qt.packed, qt.scale, qt.zero, up=u, **kw)
    torch.cuda.synchronize()
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_cuda_pipelined_gemv_matches_plain_and_gemv(M, nbits, swiglu):
    """The pipelined grouped GEMV against its plain version, the grouped
    form (f32 out within 1e-4 normalized: summation order only), and
    against the grouped GEMV of the public wrapper without the switch
    (the same splits, products and sums in the same order, so the same
    bits), on bf16 inputs, two layers of a stack, K over two superblocks;
    one launch per call on the pipelined counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(70 + nbits + M)
    N, K, L = 320, 2048, 2
    qts = [tq.quantize(torch.from_numpy(rng.normal(size=(N, K)).astype(
        np.float32) * 0.02).cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
        for _ in range(L)]
    stack = [torch.stack([getattr(q, f) for q in qts])
             for f in ("packed", "scale", "zero")]
    x, u = (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                             ).cuda().to(torch.bfloat16) for _ in range(2))
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qts[0].superblock, out_dtype=torch.float32)
    before = (tqm.quant_matmul_indexed_pipe.launches,
              tqm.quant_matmul_swiglu_indexed_pipe.launches)
    for layer in range(L):
        if swiglu:
            got = tqm.quant_matmul_swiglu_indexed_pipe(x, u, *stack, layer, **kw)
            ref = tqm.quant_matmul_swiglu_indexed(x, u, *stack, layer, **kw)
        else:
            got = tqm.quant_matmul_indexed_pipe(x, *stack, layer, **kw)
            ref = tqm.quant_matmul_indexed(x, *stack, layer, **kw)
        want = tqm.qmm_grouped_plain(x, *(s[layer] for s in stack),
                                     up=u if swiglu else None, **kw)
        torch.cuda.synchronize()
        _norm_close(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
        assert torch.equal(got, ref)
    after = (tqm.quant_matmul_indexed_pipe.launches,
             tqm.quant_matmul_swiglu_indexed_pipe.launches)
    assert after[int(swiglu)] - before[int(swiglu)] == L
    assert after[1 - int(swiglu)] == before[1 - int(swiglu)]


@pytest.mark.cuda
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_cuda_pipelined_gemv_rows_independent_of_M(nbits, swiglu):
    """Row m of an M = 5 call of the pipelined grouped GEMV has the bits of
    the same activation row alone (M = 1), as the grouped GEMV's rows do:
    the splits are the grouped GEMV's, reckoned at the largest M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(140 + nbits + 10 * swiglu)
    N, K = 4096, 4096
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
    x, u = (torch.from_numpy(rng.normal(size=(5, K)).astype(np.float32)
                             ).cuda().to(torch.bfloat16) for _ in range(2))
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock, out_dtype=torch.bfloat16)

    def call(rows):
        if swiglu:
            return tqm.quant_matmul_swiglu_indexed_pipe(x[rows], u[rows],
                                                        *stack, **kw)
        return tqm.quant_matmul_indexed_pipe(x[rows], *stack, **kw)

    counter = (tqm.quant_matmul_swiglu_indexed_pipe if swiglu
               else tqm.quant_matmul_indexed_pipe)
    before = counter.launches
    five = call(slice(0, 5))
    for m in range(5):
        assert torch.equal(call(slice(m, m + 1))[0], five[m]), m
    assert counter.launches - before == 6


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_cuda_mlp_kernel_matches_plain_and_chain(M, nbits):
    """The one-launch decode MLP against its plain version, the grouped
    form (normalized 2e-2, the suite's bf16 decode tolerance: gate, up and
    the activation are rounded to bf16 on both sides), and against the
    public wrappers' separate gateup -> SwiGLU-down chain of grouped GEMVs
    (the same splits and sums in the same order, so the same bits); the
    intermediate width (1920) pads to 2048, so the zeroing past it is
    exercised.  Two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(80 + nbits + M)
    H, I, L = 1024, 1920, 2

    def stack(n, k):
        qts = [tq.quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
            np.float32) * 0.03).cuda(), nbits=nbits,
            meta_dtype=torch.bfloat16) for _ in range(L)]
        return ([torch.stack([getattr(q, f) for q in qts])
                 for f in ("packed", "scale", "zero")], qts[0].superblock)

    gu, sb = stack(2 * I, H)
    dn, sb_d = stack(H, I)
    assert sb == sb_d == 1024
    x = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, gu_shape=(2 * I, H),
              d_shape=(H, I), superblock=sb, out_dtype=torch.float32)
    before = tqm.quant_matmul_mlp_indexed.launches
    for layer in range(L):
        got = tqm.quant_matmul_mlp_indexed(x, *gu, *dn, layer, **kw)
        again = tqm.quant_matmul_mlp_indexed(x, *gu, *dn, layer, **kw)
        want = tqm.qmm_mlp_grouped_plain(x, *(s[layer] for s in gu),
                                         *(s[layer] for s in dn), **kw)
        gkw = dict(nbits=nbits, group_size=128, superblock=sb)
        g = tqm.quant_matmul_indexed(x, *gu, layer, shape=(2 * I, H), **gkw)
        chain = tqm.quant_matmul_swiglu_indexed(
            g[:, :I], g[:, I:], *dn, layer, shape=(H, I),
            out_dtype=torch.float32, **gkw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got, chain)
        _norm_close(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2)
    assert tqm.quant_matmul_mlp_indexed.launches - before == 2 * L


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 3, 5, 8])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_grouped_gemv_matches_grouped_plain(nbits, M, swiglu, out_dtype,
                                                 meta):
    """The grouped tensor-core GEMV (bf16 x, M <= 8) at every width against
    its plain version, the grouped form: N = 320 is not a multiple of the
    256-column tile, K = 2048 (superblock 1024) is split over blocks; f32
    out within 1e-4 (normalized; summation order only), bf16 out one
    rounding; the SwiGLU prologue through quant_matmul_swiglu_indexed; two
    calls give the same bits; one launch per call, counted as grouped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(100 + M + 10 * swiglu + 100 * nbits)
    N, K = 320, 2048
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=meta)
    x, u = (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                             ).cuda().to(torch.bfloat16) for _ in range(2))
    assert tqm._grouped_applies(x, qt.packed, qt.scale, qt.zero, nbits, 128,
                                qt.superblock)
    blocks = tqm._grouped_blocks(nbits, swiglu, int(meta == torch.bfloat16),
                                 128, qt.superblock, 0)
    assert tqm._grouped_splits(N, nbits, qt.superblock, K, blocks,
                               x.device)[0] >= 2
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock, out_dtype=out_dtype)
    counter = (tqm.quant_matmul_swiglu_indexed if swiglu
               else tqm.quant_matmul if nbits == 8
               else tqm.quant_matmul_indexed)
    before = counter.launches, counter.grouped_launches

    def call():
        stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
        if swiglu:
            return tqm.quant_matmul_swiglu_indexed(x, u, *stack, **kw)
        if nbits == 8:
            return tqm.quant_matmul(x, qt, out_dtype=out_dtype)
        return tqm.quant_matmul_indexed(x, *stack, **kw)

    got, again = call(), call()
    want = tqm.qmm_grouped_plain(x, qt.packed, qt.scale, qt.zero,
                                 up=u if swiglu else None, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    atol = 1e-4 if out_dtype == torch.float32 else 1e-2
    _norm_close(got.float().cpu().numpy(), want.float().cpu().numpy(), atol)
    assert torch.equal(got, again)
    assert (counter.launches - before[0],
            counter.grouped_launches - before[1]) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_grouped_gemv_rows_independent_of_M(nbits, swiglu):
    """Row m of an M = 5 call (the speculative verify's gamma + 1 rows)
    has the bits of the same activation row alone (M = 1): the MMA's n8
    side holds every row, and the splits (reckoned at the largest M) and
    sums do not depend on M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(130 + nbits + 10 * swiglu)
    N, K = 4096, 4096
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
    x, u = (torch.from_numpy(rng.normal(size=(5, K)).astype(np.float32)
                             ).cuda().to(torch.bfloat16) for _ in range(2))
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock, out_dtype=torch.bfloat16)

    def call(rows):
        if swiglu:
            return tqm.quant_matmul_swiglu_indexed(x[rows], u[rows], *stack,
                                                   **kw)
        return tqm.quant_matmul_indexed(x[rows], *stack, **kw)

    before = tqm.quant_matmul_indexed.grouped_launches + \
        tqm.quant_matmul_swiglu_indexed.grouped_launches
    five = call(slice(0, 5))
    for m in range(5):
        assert torch.equal(call(slice(m, m + 1))[0], five[m]), m
    assert (tqm.quant_matmul_indexed.grouped_launches
            + tqm.quant_matmul_swiglu_indexed.grouped_launches
            - before) == 6


#: (group, superblock) layouts the common checks accept, for every width
_LAYOUTS = [(64, 64), (64, 128), (64, 192), (128, 384), (64, 256), (128, 256),
            (128, 512), (64, 768), (128, 1024), (256, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_cuda_grouped_ring_holds_two_blocks_per_sm(nbits):
    """The shipped ring's shared memory and registers let two grouped
    blocks share an SM at 8, 4 and 2 bits (M = 8, no SwiGLU, bf16 meta,
    superblock 1024), by the library's own occupancy query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    assert tqm._grouped_blocks(nbits, False, 1, 128, 1024, 0) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("group,superblock", _LAYOUTS)
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_grouped_gemv_routes_every_layout(nbits, group, superblock):
    """A bf16 M = 1 call at every width and every layout the common checks
    accept: where _grouped_applies takes it, the grouped GEMV launches
    (held to the grouped form; the grouped counter moves); elsewhere the
    CUDA-core GEMV (held to the f32 plain version), and the C entry of the
    grouped GEMV refuses that call too, so the predicate is the one that
    routes.  A layout whose extraction rounds straddle groups (the 8-bit
    superblocks of 192 rows of 64-row groups, 384 of 128-row groups) is
    refused by both kernels with a ValueError, never answered wrongly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(120 + group + superblock + nbits)
    N, K = 256, 1536 // superblock * superblock
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, group_size=group,
                     meta_dtype=torch.bfloat16, superblock=superblock)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)
                         ).cuda().to(torch.bfloat16)
    grouped = tqm._grouped_applies(x, qt.packed, qt.scale, qt.zero, nbits,
                                   group, superblock)
    out = torch.empty((1, N), dtype=torch.float32, device="cuda")
    # unsplit: every ring stage of K in one block
    per = tqm._grouped_stages(nbits, superblock, K)
    p = tqm._cuda.ptr
    rc = tqm._lib("amq_qmm_grouped")(
        p(x), None, 1, p(qt.packed), p(qt.scale), p(qt.zero), 1, p(out), 0,
        None, 1, K, x.stride(0), K, N, N, nbits, group, superblock, 1,
        max(1, per), tqm._cuda.stream())
    torch.cuda.synchronize()
    assert (rc == 0) == grouped, rc
    before = tqm.quant_matmul_indexed.grouped_launches
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    kw = dict(nbits=nbits, group_size=group, shape=(N, K),
              superblock=superblock, out_dtype=torch.float32)
    # the CUDA-core GEMV's own refusal: a plane's extraction round (sb * b
    # / 16 rows; 3-bit: its 2-bit and 1-bit planes) straddles groups
    spans = ((superblock // 8, superblock // 16) if nbits == 3
             else (superblock * nbits // 16,))
    nest = all(r % group == 0 or group % r == 0 for r in spans)
    if not grouped and not nest:
        with pytest.raises(ValueError, match="does not take"):
            tqm.quant_matmul_indexed(x, *stack, **kw)
        return
    got = tqm.quant_matmul_indexed(x, *stack, **kw)
    assert tqm.quant_matmul_indexed.grouped_launches - before == int(grouped)
    plain = tqm.qmm_grouped_plain if grouped else tqm.qmm_plain
    want = plain(x, qt.packed, qt.scale, qt.zero, **kw)
    torch.cuda.synchronize()
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)
    if grouped:             # the direct launch, unsplit
        _norm_close(out.cpu().numpy(), want.cpu().numpy(), 1e-4)


def _tile_inputs(nbits, M, meta, superblock, seed, N=320, K=None):
    """A one-layer stack [1, ...] quantized from numpy normals (K two
    superblocks), bf16 x and SwiGLU operand [M, K] on the card."""
    rng = np.random.default_rng(seed)
    K = K or 2 * superblock
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=meta,
                     superblock=superblock)
    x, u = (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                             ).cuda().to(torch.bfloat16) for _ in range(2))
    stack = (qt.packed[None], qt.scale[None], qt.zero[None])
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=superblock, out_dtype=torch.float32)
    return qt, stack, x, u, kw


def _tile_call(stack, x, u, swiglu, kw):
    if swiglu:
        return tqm.quant_matmul_swiglu_indexed(x, u, *stack, 0, **kw)
    return tqm.quant_matmul_indexed(x, *stack, 0, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("M", [9, 16, 64, 100, 255])
def test_cuda_tile_kernel_matches_tile_plain(M, nbits, swiglu, meta):
    """The tile kernel on wgmma against its plain version (the JAX
    package's bf16 multi-row form: the same bf16 weights, f32 out within
    1e-4 normalized, summation order only) at every M tile shape, width
    and meta type, superblock 1024; the call takes the tile route (its
    counter moves, the grouped one does not) and two calls are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    qt, stack, x, u, kw = _tile_inputs(nbits, M, meta, 1024,
                                       seed=400 + 10 * nbits + M)
    counter = (tqm.quant_matmul_swiglu_indexed if swiglu
               else tqm.quant_matmul_indexed)
    before = (counter.launches, counter.tile_launches,
              counter.grouped_launches)
    got = _tile_call(stack, x, u, swiglu, kw)
    again = _tile_call(stack, x, u, swiglu, kw)
    want = tqm.qmm_tile_plain(x, qt.packed, qt.scale, qt.zero,
                              up=u if swiglu else None, **kw)
    torch.cuda.synchronize()
    assert (counter.launches - before[0], counter.tile_launches - before[1],
            counter.grouped_launches - before[2]) == (2, 2, 0)
    assert got.shape == (M, kw["shape"][0]) and torch.equal(got, again)
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("superblock", [128, 256, 512, 1024])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_tile_kernel_superblocks(nbits, superblock):
    """quant_matmul at M = 64 on the tile route with superblocks of 128,
    256, 512 and 1024 rows (round planes of 4 to 256 word rows, so stages
    of 8, 16 and 32 rows; the 4-row planes of 1 and 3 bits at 128 rows in
    the pair form, four superblocks a stage; 3-bit in native planes), K
    over three superblocks, bf16 out, held to the tile plain version
    (1e-2 normalized: one bf16 rounding either side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    qt, _, x, _, kw = _tile_inputs(nbits, 64, torch.bfloat16, superblock,
                                   seed=500 + nbits + superblock,
                                   K=3 * superblock)
    assert tqm._tile_applies(x, qt.packed, qt.scale, qt.zero, nbits, 128,
                             superblock)
    before = tqm.quant_matmul.tile_launches
    got = tqm.quant_matmul(x, qt)
    want = tqm.qmm_tile_plain(x, qt.packed, qt.scale, qt.zero,
                              **{**kw, "out_dtype": torch.bfloat16})
    torch.cuda.synchronize()
    assert tqm.quant_matmul.tile_launches - before == 1
    assert got.dtype == torch.bfloat16
    _norm_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_tile_rows_independent_of_M(nbits, swiglu):
    """Row m of a tile call has the same bits at any M (the K splits
    depend on the weight only, every M sub-tile is the same n64 product):
    the first M rows of a 255-row call equal the M-row call, at M 9, 16,
    64, 100 and 300 (two M tiles) -- what continuous batching needs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _, stack, x, u, kw = _tile_inputs(nbits, 300, torch.bfloat16, 1024,
                                      seed=600 + nbits)
    full = _tile_call(stack, x[:255], u[:255], swiglu, kw)
    for M in (9, 16, 64, 100, 300):
        got = _tile_call(stack, x[:M], u[:M], swiglu, kw)
        n = min(M, 255)
        assert torch.equal(got[:n], full[:n]), M


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_tile_layout_agrees_with_library(nbits):
    """_tile_ns (the wrapper's predicate and split plan) and the library's
    own tile_ns agree on every weight layout -- the layouts taken and the
    word rows per ring stage (the pair form's at 4-row superblocks too) --
    over groups of 8 to 1024 rows, superblocks of 64 to 1024 and both meta
    types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    fn = tqm._cuda.library("quant_matmul_tile").amq_qmm_tile_rows
    fn.argtypes = [tqm._c_int] * 4
    fn.restype = tqm._c_int
    for sb in range(64, 1025, 64):
        for gs in (8, 16, 32, 48, 64, 128, 192, 256, 512, 1024):
            for mb in (0, 1):
                assert fn(nbits, gs, sb, mb) == tqm._tile_ns(
                    nbits, gs, sb, mb), (nbits, gs, sb, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [320, 90])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 5, 6, 8])
def test_cuda_dequant_kernel_equals_plain(nbits, N):
    """amq_dequant_kn is torch.equal to the plain version at every width,
    in f32 and bf16 out, from f32 and bf16 meta; K = 1152 pads to 1280
    (the pad rows are not written); N = 90 takes the 1-column path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(110 + nbits + N)
    W = torch.from_numpy(rng.normal(size=(N, 1152)).astype(np.float32))
    before = tdq.dequantize_kn.launches
    for meta in (torch.float32, torch.bfloat16):
        qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=meta)
        for dt in (torch.float32, torch.bfloat16):
            got = tdq.dequantize_kn(qt, dt)
            want = tq.dequantize_kn(qt, dt)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == (1152, N)
            assert torch.equal(got, want)
    assert tdq.dequantize_kn.launches - before == 4


@pytest.mark.cuda
def test_cuda_dense_head_bf16_route_close_to_f32_route():
    """The dense logits in bf16 compute: one bf16 x bf16 product with f32
    accumulation (aten::mm.dtype) against the float32 product of the same
    values; both sum exact products in f32, so only the order differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.models.linear import matmul_out_f32
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 7, 512), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((1000, 512), generator=g, device="cuda").to(torch.bfloat16)
    got = matmul_out_f32(x, w.T, torch.bfloat16)
    want = torch.matmul(x.float(), w.float().T)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, 7, 1000)
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)


def _attn_inputs(B, Hkv, G, hd, T, offsets, seed, q_dtype=torch.float32,
                 cache_dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hkv, G, hd, generator=g, device="cuda").to(q_dtype)
    kc, vc = (torch.randn(2, B, Hkv, T, hd, generator=g, device="cuda").to(
        cache_dtype) for _ in range(2))
    kn, vn = (torch.randn(B, Hkv, hd, generator=g, device="cuda").to(q_dtype)
              for _ in range(2))
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, kc, vc, kn, vn, offs


#: offsets spread around the chat cells' ~1300 live keys
_CHAT_OFFSETS = (613, 877, 1029, 1300, 1311, 1502, 1777, 1990)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=4, Hkv=8, G=4, hd=128, T=200, offsets=(1, 63, 64, 199)),
    # a long context: each warp's share spans many chunks
    dict(B=1, Hkv=4, G=1, hd=128, T=4096, offsets=(4000,)),
    # G 16 (four groups of four heads), hd 64
    dict(B=2, Hkv=2, G=16, hd=64, T=200, offsets=(0, 150)),
    # split route (span 128 at Hkv 4 in f32, 256 in bf16): offsets at 0,
    # 1, a split boundary - 1, the boundary, + 1, and 4000
    dict(B=6, Hkv=4, G=1, hd=128, T=4096, offsets=(0, 1, 127, 128, 129, 4000)),
    dict(B=6, Hkv=4, G=1, hd=128, T=4096, offsets=(0, 1, 255, 256, 257, 4000),
         dtype=torch.bfloat16),
    dict(B=6, Hkv=4, G=7, hd=128, T=4096, offsets=(0, 1, 255, 256, 257, 4000),
         dtype=torch.bfloat16),
    # the chat cells' shapes: qwen (G 7, Hkv 4) and mistral (G 4, Hkv 8)
    dict(B=8, Hkv=4, G=7, hd=128, T=4096, offsets=_CHAT_OFFSETS),
    dict(B=8, Hkv=4, G=7, hd=128, T=4096, offsets=_CHAT_OFFSETS,
         dtype=torch.bfloat16),
    dict(B=8, Hkv=8, G=4, hd=128, T=4096, offsets=_CHAT_OFFSETS),
    dict(B=8, Hkv=8, G=4, hd=128, T=4096, offsets=_CHAT_OFFSETS,
         dtype=torch.bfloat16),
    # G 9-16 on the tensor cores: two passes of 8 heads
    dict(B=2, Hkv=2, G=12, hd=64, T=1024, offsets=(130, 1000),
         dtype=torch.bfloat16),
], ids=["gqa", "t4096", "g16", "t4096-splits", "t4096-splits-bf16",
        "t4096-splits-g7-bf16",
        "qwen-c8", "qwen-c8-bf16", "mistral-c8", "mistral-c8-bf16",
        "g12-bf16"])
def test_cuda_decode_attention_matches_plain(case):
    """f32 out (f32, or bf16 q and cache as served): the kernel within the
    JAX suite's tolerance of the plain version on the same inputs, with no
    window, a window of 16 and one of 300 (across split boundaries); two
    calls give the same bits; the split route counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    case = dict(case)
    dtype = case.pop("dtype", torch.float32)
    q, kc, vc, kn, vn, offs = _attn_inputs(seed=0, q_dtype=dtype,
                                           cache_dtype=dtype, **case)
    splits = tda.split_plan(case["Hkv"], case["hd"], case["T"],
                            kc.element_size())[1]
    for window in (None, 16, 300):
        before = tda.decode_attention_indexed.split_launches
        got = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                           window=window, out_dtype=torch.float32)
        assert (tda.decode_attention_indexed.split_launches - before
                == (splits > 1))
        again = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                             window=window,
                                             out_dtype=torch.float32)
        want = tda.decode_attention_plain(q, kc[1], vc[1], kn, vn, offs,
                                          window, torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_dtypes(q_dtype, cache_dtype, out_dtype):
    """Each of the kernel's eight dtype instantiations (at G 1 and G 4)
    against the plain version on the same inputs; a bf16 output carries
    one rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for G in (1, 4):
        q, kc, vc, kn, vn, offs = _attn_inputs(3, 4, G, 128, 200, (1, 64, 199),
                                               seed=G, q_dtype=q_dtype,
                                               cache_dtype=cache_dtype)
        got = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 0,
                                           out_dtype=out_dtype)
        want = tda.decode_attention_plain(q, kc[0], vc[0], kn, vn, offs,
                                          None, torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        atol = 2e-4 if out_dtype == torch.float32 else 1e-2
        _norm_close(got.float().cpu().numpy(), want.cpu().numpy(), atol=atol)


@pytest.mark.cuda
def test_cuda_decode_attention_batch_independent():
    """Each row of a B = 4 call gives the same bits as that row alone at
    B = 1: the warps' shares follow the row's own offset, never B or the
    other rows (what the token-exact slot-batched run rests on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q, kc, vc, kn, vn, offs = _attn_inputs(4, 32, 1, 128, 200,
                                           (1, 63, 64, 199), seed=5)
    full = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                        out_dtype=torch.float32)
    for b in range(4):
        alone = tda.decode_attention_indexed(
            q[b:b + 1].contiguous(), kc[:, b:b + 1].contiguous(),
            vc[:, b:b + 1].contiguous(), kn[b:b + 1].contiguous(),
            vn[b:b + 1].contiguous(), offs[b:b + 1].contiguous(), 1,
            out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(full[b:b + 1], alone), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_split_batch_independent(dtype):
    """At multi-split lengths (T 4096, span 128 / 256 at Hkv 4) each row of a B = 8
    call gives the same bits as that row alone: the splits follow the row's
    own offset and the model's shape, never B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q, kc, vc, kn, vn, offs = _attn_inputs(8, 4, 7, 128, 4096, _CHAT_OFFSETS,
                                           seed=6, q_dtype=dtype,
                                           cache_dtype=dtype)
    full = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                        out_dtype=torch.float32)
    for b in range(8):
        alone = tda.decode_attention_indexed(
            q[b:b + 1].contiguous(), kc[:, b:b + 1].contiguous(),
            vc[:, b:b + 1].contiguous(), kn[b:b + 1].contiguous(),
            vn[b:b + 1].contiguous(), offs[b:b + 1].contiguous(), 1,
            out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(full[b:b + 1], alone), b


@pytest.mark.cuda
def test_cuda_decode_attention_graph_replays_new_offsets():
    """A captured split-route call (bf16, the chat cells' shape) replayed
    after the device offsets change in place: each replay equals the eager
    call at those offsets bit for bit and the plain version within 2e-4
    (the scratch holds no state from one replay to the next)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q, kc, vc, kn, vn, offs = _attn_inputs(8, 8, 4, 128, 4096, _CHAT_OFFSETS,
                                           seed=7, q_dtype=torch.bfloat16,
                                           cache_dtype=torch.bfloat16)

    def call():
        return tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 0,
                                            out_dtype=torch.float32)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for offsets in (_CHAT_OFFSETS, (4096, 0, 1, 255, 256, 257, 2000, 3001),
                    _CHAT_OFFSETS[::-1]):
        offs.copy_(torch.tensor(offsets, dtype=torch.int32))
        graph.replay()
        eager = call()
        want = tda.decode_attention_plain(q, kc[0], vc[0], kn, vn, offs, None,
                                          torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), offsets
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


#: (B, Hq, Hkv, S, T, d, offset, dtype, causal): the JAX suite's five cases
#: (tests/test_flash_attention.py), bf16, d 64, non-causal; two calls give
#: the same bits
FLASH_CASES = [
    (1, 4, 2, 128, 128, 128, 0, torch.float32, True),
    (1, 4, 2, 128, 136, 128, 0, torch.float32, True),
    (1, 4, 2, 128, 320, 128, 0, torch.float32, True),
    (1, 4, 2, 128, 200, 128, 64, torch.float32, True),
    (2, 8, 2, 256, 264, 128, 8, torch.float32, True),
    (2, 8, 8, 512, 512, 128, 0, torch.bfloat16, True),
    (2, 16, 2, 256, 256, 64, 0, torch.float32, True),
    (1, 4, 4, 128, 192, 128, 0, torch.float32, False),
    # bf16 (the tensor-core kernel): S 192 with GQA (half of a 128-row
    # tile), d 64, an offset with T unaligned to 64 (the diagonal mid-tile),
    # d 64 with GQA and an offset, non-causal
    (1, 8, 2, 192, 192, 128, 0, torch.bfloat16, True),
    (2, 4, 2, 256, 256, 64, 0, torch.bfloat16, True),
    (1, 4, 4, 128, 200, 128, 40, torch.bfloat16, True),
    (1, 8, 2, 192, 328, 64, 136, torch.bfloat16, True),
    (1, 4, 4, 128, 192, 128, 0, torch.bfloat16, False),
    # f32 (split TF32 on mma.sync, 128-row blocks of 16-row warps): S and
    # T unaligned to a warp's rows or a key tile, with GQA and an offset;
    # non-causal at d 64 with a partial warp
    (1, 8, 2, 200, 333, 64, 133, torch.float32, True),
    (2, 4, 4, 77, 77, 64, 0, torch.float32, False),
    (1, 4, 1, 136, 300, 128, 164, torch.float32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_cuda_flash_attention_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.ops import flash_attention as tfa
    B, Hq, Hkv, S, T, d, offset, dtype, causal = case
    g = torch.Generator(device="cuda").manual_seed(S + T + d)
    q = torch.randn(B, Hq, S, d, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, Hkv, T, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    off = torch.tensor(offset, dtype=torch.int32, device="cuda")
    got = tfa.flash_attention(q, k, v, off, causal=causal)
    again = tfa.flash_attention(q, k, v, off, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, off, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        # bf16 output and p each carry one bf16 rounding (2^-8 relative)
        _norm_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_takes_misaligned_views(dtype):
    """Contiguous views whose data is not 16-byte aligned (the kernels read
    16-byte chunks) give the bits of the same tensors aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.ops import flash_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (1, 4, 128, 64)
    n = math.prod(shape)
    views = [torch.randn(n + 1, generator=g, device="cuda").to(dtype)[1:]
             .view(shape) for _ in range(3)]
    assert all(t.data_ptr() % 16 for t in views)
    got = tfa.flash_attention(*views)
    want = tfa.flash_attention(*(t.clone() for t in views))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_cache", [False, True])
def test_cuda_model_forward_flash_matches_einsum(with_cache):
    """tiny-llama in f32 on the card at S = 128: the forward through the
    flash kernel against the same forward with the einsum attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.models import llama
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.ops import flash_attention as tfa
    cfg = get_config("tiny-llama")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    outs = []
    for kernels in (True, False):
        cache = (llama.KVCache.create(cfg, 2, 200, dtype=torch.float32,
                                      device="cuda") if with_cache else None)
        before = tfa.flash_attention.launches
        with llama.forward_kernels(kernels):
            if cache is not None:       # a short first chunk, then S = 128
                _, cache = llama.forward(params, cfg, toks[:, :8], cache=cache)
            logits, _ = llama.forward(params, cfg, toks, cache=cache)
        assert tfa.flash_attention.launches - before == (
            cfg.num_layers if kernels else 0)
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["gemv", "grouped"])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_cuda_gemv_attrib_variants_match_plain(nbits, swiglu, body):
    """The attribution kernel's four variants on layer 1 of a random stack
    (N 320: more than one column tile, so K splits and their atomics run):
    full equal with torch.equal to the route whose bits it carries (the
    grouped body: the public decode GEMV, which takes the grouped GEMV;
    the GEMV body: the CUDA-core GEMV, the wrapper's private route), each
    stripped variant to its plain version (XOR folds and code sums
    exactly, fma_only / mma_only at the bf16 GEMV tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.probes import chain, kernel_attrib as ka
    N, K = 320, 2048
    gen = torch.Generator(device="cuda").manual_seed(90 + nbits)
    packed, scale, zero, sb = chain.random_stack(N, K, nbits, 2, gen, "cuda")
    x, u = (torch.randn((1, K), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    up = u if swiglu else None
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb)
    prod = ka.production(body, x, up, packed, scale, zero, 1, **kw)
    before = ka.gemv_attrib.launches
    for variant in ka.VARIANTS[body]:
        got = ka.gemv_attrib(x, packed[1], scale[1], zero[1], up=up,
                             variant=variant, body=body, **kw)
        want = ka.attrib_plain(variant, x, packed[1], scale[1], zero[1],
                               up=up, body=body, **kw)
        torch.cuda.synchronize()
        rec = ka._check(variant, got, want, prod)
        assert rec["ok"], (variant, rec)
    assert ka.gemv_attrib.launches - before == len(ka.VARIANTS[body])


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_cuda_gemv_attrib_grouped_full_equals_quant_matmul_indexed(nbits):
    """The grouped body's full at the 7B gateup and down shapes (K splits
    of the grouped plan) is torch.equal to quant_matmul_indexed /
    quant_matmul_swiglu_indexed at M = 1, which took the grouped GEMV; two
    calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.probes import chain, kernel_attrib as ka
    for (N, K), swiglu in (((22016, 4096), False), ((4096, 11008), True)):
        gen = torch.Generator(device="cuda").manual_seed(70 + nbits)
        packed, scale, zero, sb = chain.random_stack(N, K, nbits, 2, gen,
                                                     "cuda")
        x, u = (torch.randn((1, K), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        up = u if swiglu else None
        kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb)
        wrapper = (tqm.quant_matmul_swiglu_indexed if swiglu
                   else tqm.quant_matmul_indexed)
        grouped = wrapper.grouped_launches
        want = ka.production("grouped", x, up, packed, scale, zero, 1, **kw)
        assert wrapper.grouped_launches == grouped + 1
        got = [ka.gemv_attrib(x, packed[1], scale[1], zero[1], up=up,
                              body="grouped", **kw).y for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["gemv", "grouped"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_cuda_gemv_attrib_variants_pinned_to_full(nbits, body):
    """Every variant of the attribution kernel launches with as many blocks
    resident per SM as full (with and without the grouped ring's SwiGLU
    operand), so their times compare at one occupancy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.probes import kernel_attrib as ka
    for swiglu in (False, True):
        occ = {v: ka.occupancy(v, body, nbits=nbits, superblock=1024,
                               swiglu=swiglu)
               for v in ka.VARIANTS[body]}
        assert occ["full"]["blocks_per_sm"] >= 1, occ
        assert {o["blocks_per_sm"] for o in occ.values()} == {
            occ["full"]["blocks_per_sm"]}, occ


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1920, 4096, 11264])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_cuda_extract_ahead_matches_plain(nbits, K):
    """The extract-ahead GEMV on wgmma against its plain version and the
    dequantize-then-matmul reference on quantized weights (N 320: a ragged
    second column tile; K 1920 pads to two superblocks, so x's zero tail
    and the pad rows run; K 4096 and 11264 are the 7B sites' K, split
    across blocks); two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.probes import pipelined_gemv as pg
    rng = np.random.default_rng(95 + nbits + K)
    N = 320
    qt = tq.quantize(torch.from_numpy(rng.normal(size=(N, K)).astype(
        np.float32) * 0.02).cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).cuda().to(
        torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock)
    before = pg.gemv_extract_ahead.launches
    got = pg.gemv_extract_ahead(x, qt.packed, qt.scale, qt.zero, **kw)
    again = pg.gemv_extract_ahead(x, qt.packed, qt.scale, qt.zero, **kw)
    want = pg.extract_ahead_plain(x, qt.packed, qt.scale, qt.zero, **kw)
    ref = tqm.quant_matmul_reference(x, qt, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert pg.gemv_extract_ahead.launches - before == 2
    assert got.shape == (1, N) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    _norm_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)
    _norm_close(got.float().cpu().numpy(), ref.cpu().numpy(), 2e-2)


#: OWQ's compacted 7B layouts: (N, Kp, superblock) -- q/k/v/o and gate/up
#: keep Kp 4096 (superblock 1024), down's 10954 non-outlier columns pad to
#: Kp 11008 (superblock 256: 43 superblocks, spanning ring stages below 4
#: bits)
OWQ_LAYOUTS = {"attn": (4096, 4096, 1024), "down": (4096, 11008, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(OWQ_LAYOUTS))
@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 64])
def test_cuda_quant_matmul_at_owq_layouts(site, nbits, M):
    """``quant_matmul`` (the route ``owq_matmul`` takes on the card) at
    OWQ's packed layouts, 3-bit in native planes, bf16 x, f32 meta (as
    ``owq_pack`` writes it), against ``quant_matmul_reference`` and, on
    the grouped route, its plain version; the grouped counter moves at
    every M = 1 call (down's 2/3-bit layouts on the spanning kernel), the
    tile counter at M = 64 (the tile kernel takes every OWQ layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.core import bitpack
    N, Kp, sb = OWQ_LAYOUTS[site]
    assert bitpack.pick_superblock(Kp) == sb
    g = torch.Generator(device="cuda").manual_seed(nbits * 10 + M)
    codes = torch.randint(0, 2**nbits, (Kp, N), generator=g, device="cuda")
    qt = tq.QuantizedTensor(
        packed=bitpack.pack(codes, nbits, sb),
        scale=torch.rand((Kp // 128, N), generator=g, device="cuda") * 0.02,
        zero=torch.rand((Kp // 128, N), generator=g, device="cuda")
        * (2**nbits - 1), nbits=nbits, group_size=128, shape=(N, Kp),
        superblock=sb)
    x = torch.randn((M, Kp), generator=g, device="cuda").to(torch.bfloat16)
    grouped = tqm._grouped_applies(x, qt.packed, qt.scale, qt.zero, nbits,
                                   128, sb)
    assert grouped == (M == 1)
    tile = tqm._tile_applies(x, qt.packed, qt.scale, qt.zero, nbits, 128, sb)
    assert tile == (M == 64)
    before = (tqm.quant_matmul.launches, tqm.quant_matmul.grouped_launches,
              tqm.quant_matmul.tile_launches)
    got = tqm.quant_matmul(x, qt)
    want = tqm.quant_matmul_reference(x, qt)
    torch.cuda.synchronize()
    assert (tqm.quant_matmul.launches - before[0],
            tqm.quant_matmul.grouped_launches - before[1],
            tqm.quant_matmul.tile_launches - before[2]) == (
                1, int(grouped), int(tile))
    assert got.dtype == torch.bfloat16
    _norm_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                atol=2e-2)
    if grouped:
        plain = tqm.qmm_grouped_plain(
            x, qt.packed, qt.scale, qt.zero, nbits=nbits, group_size=128,
            shape=(N, Kp), superblock=sb, out_dtype=torch.bfloat16)
        _norm_close(got.float().cpu().numpy(), plain.float().cpu().numpy(),
                    atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("nbits,superblock", [
    (1, 128), (1, 256), (1, 512), (2, 128), (2, 256), (3, 128), (3, 256),
    (4, 128)])
def test_cuda_spanning_gemv_matches_grouped_plain(nbits, superblock, M,
                                                  swiglu, meta):
    """The grouped GEMV at superblocks smaller than a ring stage (the
    spanning kernel; 4-row superblocks of 1 and 3 bits on the round-pair
    consumer) against its plain version, the grouped form: an odd count
    of superblocks (the last stage part full), K short of Kp (zeros past
    K), N = 320 not a multiple of the column tile, K split over blocks,
    groups of 64 and of 128; f32 out within 1e-4 normalized, two calls
    with the same bits, one grouped launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.core import bitpack
    N, Kp = 320, 27 * superblock
    K = Kp - superblock + 64
    for group in (64, 128):
        g = torch.Generator(device="cuda").manual_seed(
            nbits * 1000 + superblock + M + 7 * swiglu + group)
        codes = torch.randint(0, 2**nbits, (Kp, N), generator=g,
                              device="cuda")
        scale = (torch.rand((Kp // group, N), generator=g, device="cuda")
                 * 0.02).to(meta)
        zero = (torch.rand((Kp // group, N), generator=g, device="cuda")
                * (2**nbits - 1)).to(meta)
        stack = (bitpack.pack(codes, nbits, superblock)[None], scale[None],
                 zero[None], 0)
        x, u = (torch.randn((M, K), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        assert tqm._grouped_applies(x, stack[0][0], scale, zero, nbits, group,
                                    superblock)
        assert not tqm._grouped_whole_stages(nbits, superblock)
        kw = dict(nbits=nbits, group_size=group, shape=(N, K),
                  superblock=superblock, out_dtype=torch.float32)
        splits = tqm._grouped_plan(N, Kp, nbits, swiglu, int(
            meta == torch.bfloat16), group, superblock, 0)[0]
        assert splits >= 2
        counter = (tqm.quant_matmul_swiglu_indexed if swiglu
                   else tqm.quant_matmul_indexed)
        before = counter.grouped_launches

        def call():
            if swiglu:
                return tqm.quant_matmul_swiglu_indexed(x, u, *stack, **kw)
            return tqm.quant_matmul_indexed(x, *stack, **kw)

        got, again = call(), call()
        want = tqm.qmm_grouped_plain(x, stack[0][0], scale, zero,
                                     up=u if swiglu else None, **kw)
        torch.cuda.synchronize()
        assert counter.grouped_launches - before == 2
        _norm_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 4])

def test_cuda_gptq_matches_cpu(bits):
    """GPTQ of one float32 layer on the card within 2e-5 of the CPU (TF32
    off, as ``cli.common.setup_torch`` sets it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from amq_tpu_torch.cli.common import setup_torch
    from amq_tpu_torch.quantization.gptq import gptq_quantize_weight
    setup_torch()
    rng = np.random.default_rng(bits)
    W = rng.normal(size=(256, 512)).astype(np.float32)
    X = rng.normal(size=(2048, 512)).astype(np.float32)
    H = torch.from_numpy((2.0 / X.shape[0]) * X.T @ X)
    want = gptq_quantize_weight(torch.from_numpy(W), H, bits)
    got = gptq_quantize_weight(torch.from_numpy(W).cuda(), H.cuda(), bits)
    off = (got.cpu() - want).abs() > 2e-5 + 2e-5 * want.abs()
    # a one-ulp difference may flip a rounding (and its row's rest)
    assert off.float().mean().item() <= 0.005, off.sum().item()


# ---------------------------------------------------------------------------
# the serving loops as captured CUDA graphs

@pytest.fixture(scope="module")
def tiny_serving():
    """A three-layer stacked model at a width the decode kernels take
    (hidden 1024, head dim 128), 2/3/4 bits per layer, fused sites, bf16
    meta, 8-bit head, built on the card from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses
    from amq_tpu_torch.models import llama as tllama
    from amq_tpu_torch.models.config import LINEAR_NAMES, get_config
    from amq_tpu_torch.models.stacked import (SERVE_CONTAINERS,
                                              merge_containers, stack_proxies)
    from amq_tpu_torch.models.transform import quantize_model
    cfg = dataclasses.replace(get_config("tiny-llama"), hidden_size=1024,
                              intermediate_size=2048, num_heads=8,
                              num_kv_heads=8, num_layers=3, vocab_size=1024)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tllama.init_params(cfg, gen, device="cuda")
    bits = (2, 3, 4)
    arch = {"linear": {n: [bits[i % 3] for i in range(cfg.num_layers)]
                       for n in LINEAR_NAMES}}
    proxies = [quantize_model(params, cfg, b, meta_dtype=torch.bfloat16)
               for b in bits]
    model = merge_containers(stack_proxies(
        proxies, bits, arch, container_bits=SERVE_CONTAINERS, head_bits=8))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32)
    return cfg, model, prompt


def _slot_run(cfg, model, graphs):
    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.engine import ContinuousBatcher, Request
    se = SlotEngine(model, cfg, n_slots=2, max_len=48,
                    compute_dtype=torch.float32, prefill_buckets=(8, 16),
                    chunk_steps=3, prefill_chunk_len=8, graphs=graphs)
    batcher = ContinuousBatcher(n_slots=2, max_len=48)
    rng = np.random.default_rng(1)
    for u, n in enumerate((12, 5, 9, 7)):
        batcher.submit(Request(uid=u, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=6))
    return se.run(batcher), se.runner


@pytest.mark.cuda
def test_cuda_graphs_equal_the_eager_loop_f32(tiny_serving):
    """float32: generate, speculative decoding (tokens, rounds, accepted)
    and the slot engine (decode chunks, whole and chunked slot prefills)
    on captured graphs token-exact against the eager loop; the eager
    runners capture nothing."""
    from amq_tpu_torch.serving.engine import Engine
    from amq_tpu_torch.serving.speculative import SpeculativeEngine
    cfg, model, prompt = tiny_serving
    out = {}
    for graphs in (False, True):
        eng = Engine(model, cfg, max_len=48, compute_dtype=torch.float32,
                     cache_dtype=torch.float32, graphs=graphs)
        toks = eng.generate(prompt, max_new_tokens=20)
        sp = SpeculativeEngine(eng, draft_params=model, gamma=3)
        spec, stats = sp.generate(prompt, max_new_tokens=18)
        slot, runner = _slot_run(cfg, model, graphs)
        out[graphs] = (toks, spec, (stats.rounds, stats.accepted), slot)
        for r in (eng.runner, sp.runner, runner):
            assert r.graphed == graphs
            assert (r.captures > 0) == graphs and (r.replays > 0) == graphs
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    assert out[True][2] == out[False][2]
    assert out[True][3] == out[False][3]


@pytest.mark.cuda
def test_cuda_graph_step_logits_bf16(tiny_serving):
    """bf16: the first decode step's forward replayed from its graph
    against the same forward run eagerly from the same cache state,
    within 1e-2 of the largest logit (the bf16 kernel tolerance)."""
    from amq_tpu_torch.serving.engine import Engine
    cfg, model, prompt = tiny_serving
    eng = Engine(model, cfg, max_len=48)
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    with torch.inference_mode():
        want = eng._forward(model, first[:, None], cache)[0][0, -1].float()
    buf = eng.runner.buffers(("step_logits",), tok=((1,), torch.int32),
                             logits=((cfg.vocab_size,), torch.float32))
    buf.tok.copy_(first)

    def body():
        logits, _ = eng._forward(model, buf.tok[:, None], cache)
        buf.logits.copy_(logits[0, -1])

    with torch.inference_mode():
        eng.runner.run(("step_logits",), body, state=(cache.length,))
    torch.cuda.synchronize()
    assert int(cache.length) == prompt.shape[1]
    _norm_close(buf.logits.cpu().numpy(), want.cpu().numpy(), atol=1e-2)


@pytest.mark.cuda
def test_cuda_graph_counts_replays(tiny_serving):
    """bf16 generate: the launch counts of the graph loop (its first call
    captures) equal the eager loop's, call after call; the runner counts
    one prefill and n - 1 decode replays a generate."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.serving.engine import Engine
    cfg, model, prompt = tiny_serving
    engines = {g: Engine(model, cfg, max_len=48, graphs=g)
               for g in (False, True)}
    runs = []
    for graphs in (False, True, True):
        eng = engines[graphs]
        ops.reset_launch_counts()
        before = eng.runner.replays
        eng.generate(prompt, max_new_tokens=10)
        torch.cuda.synchronize()
        runs.append((ops.launch_counts(), ops.grouped_launch_counts(),
                     ops.tile_launch_counts()))
        assert eng.runner.replays - before == (10 if graphs else 0)
    assert runs[0][0]["decode_attention_indexed"] == 9 * cfg.num_layers
    assert runs[1] == runs[0] and runs[2] == runs[0]
    assert engines[True].runner.captures == 2
    ops.reset_launch_counts()


@pytest.mark.cuda
def test_cuda_failed_capture_raises(tiny_serving):
    """A step that reads back to the host cannot be captured: the runner
    raises (no eager fallback) and keeps no graph.  Last in this file: a
    failed capture may leave its stream's state behind."""
    from amq_tpu_torch.serving.graphs import GraphRunner
    runner = GraphRunner("cuda")
    x = torch.ones(4, device="cuda")

    def body():
        x.add_(1)
        float(x.sum())

    with pytest.raises(RuntimeError, match="no eager fallback"):
        runner.run(("host_read",), body, state=(x,))
    assert runner.captures == 0 and runner.replays == 0


# ---------------------------------------------------------------------------
# The float32 forms of rows 1, 2 and 4 (f32 activations on tensor cores)

def _f32_case(nbits, M, meta, seed, N=320, K=2048, superblock=None):
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=meta,
                     **({"superblock": superblock} if superblock else {}))
    x, u = (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                             ).cuda() for _ in range(2))
    return qt, x, u


def _f32_call(qt, x, u, swiglu, **kw):
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    if swiglu:
        return tqm.quant_matmul_swiglu_indexed(x, u, *stack, **kw)
    if qt.nbits == 8:
        return tqm.quant_matmul(x, qt, out_dtype=kw["out_dtype"])
    return tqm.quant_matmul_indexed(x, *stack, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 64, 200])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_f32_forms_match_plain(nbits, M, swiglu, meta):
    """f32 activations: M <= 8 on the grouped ring's float32 form, 8 < M
    on the tile kernel's (N = 320 not a multiple of either's columns, K =
    2048 split over blocks), within 1e-4 of the f32 function qmm_plain
    (normalized) and of the kernels' own arithmetic qmm_exact_plain, two
    calls equal, one launch per call counted on its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    qt, x, u = _f32_case(nbits, M, meta, 200 + nbits + M + 10 * swiglu)
    kw = dict(nbits=nbits, group_size=128, shape=qt.shape,
              superblock=qt.superblock, out_dtype=torch.float32)
    counter = (tqm.quant_matmul_swiglu_indexed if swiglu
               else tqm.quant_matmul if nbits == 8
               else tqm.quant_matmul_indexed)
    route = "grouped_launches" if M <= 8 else "tile_launches"
    before = counter.launches, getattr(counter, route)
    got, again = (_f32_call(qt, x, u, swiglu, **kw) for _ in range(2))
    up = u if swiglu else None
    want = tqm.qmm_plain(x, qt.packed, qt.scale, qt.zero, up=up, **kw)
    exact = tqm.qmm_exact_plain(x, qt.packed, qt.scale, qt.zero, up=up, **kw)
    torch.cuda.synchronize()
    assert (counter.launches - before[0],
            getattr(counter, route) - before[1]) == (2, 2)
    assert torch.equal(got, again)
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)
    _norm_close(got.cpu().numpy(), exact.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_f32_rows_independent_of_M(nbits):
    """Row m of a float32 call has the bits of the same row in a call of
    another M on the same route: M = 8 and 5 against each row alone on
    the grouped ring (J = 3 against J = 1 column groups), M = 200 against
    M = 64 and 9 on the tile kernel (two M tiles against one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    qt, x, u = _f32_case(nbits, 200, torch.bfloat16, 260 + nbits, N=4096,
                         K=4096)
    kw = dict(nbits=nbits, group_size=128, shape=qt.shape,
              superblock=qt.superblock, out_dtype=torch.float32)
    for rows in (8, 5):
        many = _f32_call(qt, x[:rows], u, False, **kw)
        for m in range(rows):
            assert torch.equal(_f32_call(qt, x[m:m + 1], u, False, **kw)[0],
                               many[m]), (rows, m)
    big = _f32_call(qt, x, u, False, **kw)
    for rows in (64, 9):
        assert torch.equal(_f32_call(qt, x[:rows], u, False, **kw),
                           big[:rows]), rows


@pytest.mark.cuda
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("nbits,superblock", [
    (1, 128), (1, 256), (1, 512), (2, 128), (2, 256), (3, 128), (3, 256),
    (4, 128)])
def test_cuda_f32_spanning_matches_plain(nbits, superblock, M, swiglu):
    """The float32 GEMV at superblocks smaller than a ring stage (OWQ's
    down at 2 and 3 bits among them; the 4-row superblocks, 1 and 3 bits
    at 128 rows, in the pair form), K over an odd count of superblocks so
    the last stage of K is partial: the spanning counter moves (the pair
    counter too at 4-row superblocks), within 1e-4 of qmm_plain and of the
    kernel's own arithmetic qmm_exact_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    qt, x, u = _f32_case(nbits, M, torch.float32, 300 + nbits + superblock,
                         K=superblock * 11, superblock=superblock)
    kw = dict(nbits=nbits, group_size=128, shape=qt.shape,
              superblock=qt.superblock, out_dtype=torch.float32)
    counter = (tqm.quant_matmul_swiglu_indexed if swiglu
               else tqm.quant_matmul_indexed)
    before = counter.span_launches, counter.pair_launches
    got = _f32_call(qt, x, u, swiglu, **kw)
    up = u if swiglu else None
    want = tqm.qmm_plain(x, qt.packed, qt.scale, qt.zero, up=up, **kw)
    exact = tqm.qmm_exact_plain(
        x, qt.packed, qt.scale, qt.zero, up=up, **kw,
        piece=16 if tqm._pair_layout(nbits, superblock) else None)
    torch.cuda.synchronize()
    assert (counter.span_launches - before[0],
            counter.pair_launches - before[1]) == (
                1, int(tqm._pair_layout(nbits, superblock)))
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)
    _norm_close(got.cpu().numpy(), exact.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nbits", [1, 3])
def test_cuda_pair_forms_rows_independent_of_M(nbits, dtype):
    """The pair forms at 4-row superblocks (1 and 3 bits at 128 rows, K
    over 31 superblocks as OWQ's q/k/v/o site with 31 groups): row m has
    the same bits at any M and two calls are equal -- the tile kernel's
    (bf16 and float32) first rows of a 200-row call against M 64 and 9,
    the float32 grouped ring's M 8 and 5 against each row alone (the bf16
    ring's at M <= 8: test_cuda_grouped_gemv_rows_independent_of_M) --
    and every call takes a pair form (its counters move)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(280 + nbits + (dtype == torch.float32))
    N, K = 320, 31 * 128
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=torch.float32,
                     superblock=128)
    x = torch.from_numpy(rng.normal(size=(200, K)).astype(np.float32)
                         ).cuda().to(dtype)
    kw = dict(nbits=nbits, group_size=128, shape=qt.shape, superblock=128,
              out_dtype=torch.float32)
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    fn = tqm.quant_matmul_indexed
    before = fn.pair_launches, fn.pair_tile_launches, fn.launches
    big, again = (fn(x, *stack, **kw) for _ in range(2))
    assert torch.equal(big, again)
    for rows in (64, 9):
        assert torch.equal(fn(x[:rows], *stack, **kw), big[:rows]), rows
    calls = 4
    if dtype == torch.float32:
        for rows in (8, 5):
            many = fn(x[:rows], *stack, **kw)
            calls += 1 + rows
            for m in range(rows):
                assert torch.equal(fn(x[m:m + 1], *stack, **kw)[0],
                                   many[m]), (rows, m)
    torch.cuda.synchronize()
    assert (fn.pair_launches - before[0] + fn.pair_tile_launches - before[1],
            fn.launches - before[2]) == (calls, calls)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_cuda_tile_f32_layout_agrees_with_library(nbits):
    """_tile_ns(..., exact=True) and the library's tile_ns_exact agree on
    every weight layout, as test_cuda_tile_layout_agrees_with_library
    holds the bf16 form's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    fn = tqm._cuda.library("quant_matmul_tile").amq_qmm_tile_f32_rows
    fn.argtypes = [tqm._c_int] * 4
    fn.restype = tqm._c_int
    for sb in range(64, 1025, 64):
        for gs in (8, 16, 32, 48, 64, 128, 192, 256, 512, 1024):
            for mb in (0, 1):
                assert fn(nbits, gs, sb, mb) == tqm._tile_ns(
                    nbits, gs, sb, mb, True), (nbits, gs, sb, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 64])
def test_cuda_swiglu_takes_views_of_gateup(M, dtype):
    """quant_matmul_swiglu_indexed with gate and up as the model passes
    them -- column views of one gateup output [M, 2 K + 64], row stride
    past K -- at M 1 (grouped ring) and 64 (tile kernel: bf16 through the
    SwiGLU prologue's contiguous output, f32 through the split pass)
    equals the same call on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(400 + M)
    N, K = 320, 2048
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=4, meta_dtype=torch.bfloat16)
    gu = torch.from_numpy(rng.normal(size=(M, 2 * K + 64)).astype(
        np.float32)).cuda().to(dtype)
    gate, up = gu[:, :K], gu[:, K:2 * K]
    kw = dict(nbits=4, group_size=128, shape=(N, K), superblock=qt.superblock,
              out_dtype=torch.float32)
    stack = (qt.packed[None], qt.scale[None], qt.zero[None], 0)
    got = tqm.quant_matmul_swiglu_indexed(gate, up, *stack, **kw)
    want = tqm.quant_matmul_swiglu_indexed(gate.contiguous(), up.contiguous(),
                                           *stack, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
