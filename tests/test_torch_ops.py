"""Port ops held to the JAX Pallas kernels (run in interpret mode on the
CPU, as tests/test_quant_matmul.py and tests/test_decode_attention.py run
them).  The CUDA kernels are held to the port's plain versions on a card
by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are the JAX suite's: f32 rtol = atol = 2e-4; bf16 decode GEMV
atol 2e-2 on outputs normalized by their largest magnitude.
"""

import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from amq_tpu.core import quantize as jq
from amq_tpu.ops import quant_matmul as jqm
from amq_tpu.ops.decode_attention import decode_attention_indexed as j_attn
from amq_tpu_torch.core import quantize as tq
from amq_tpu_torch.models.convert import to_tensor
from amq_tpu_torch.ops import decode_attention as tda
from amq_tpu_torch.ops import quant_matmul as tqm

from test_torch_slice import torch_one_thread  # noqa: F401


def _port_qt(qt):
    return tq.QuantizedTensor(
        packed=to_tensor(np.asarray(qt.packed)),
        scale=to_tensor(np.asarray(qt.scale)),
        zero=to_tensor(np.asarray(qt.zero)),
        nbits=qt.nbits, group_size=qt.group_size, shape=tuple(qt.shape),
        superblock=qt.superblock)


def _stack(qts):
    return tuple(jnp.stack([getattr(t, f) for t in qts])
                 for f in ("packed", "scale", "zero"))


def _norm_close(got, want, atol=2e-2):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_quant_matmul_f32(nbits, M):
    rng = np.random.default_rng(nbits + 10 * M)
    N, K = 256, 512
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)),
                     nbits=nbits)
    x = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qt))
    got = tqm.quant_matmul(torch.from_numpy(x), _port_qt(qt)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 4])
def test_quant_matmul_bf16_decode(nbits, M):
    rng = np.random.default_rng(20 + nbits + M)
    N, K = 256, 512
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=nbits)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul(x, qt, out_dtype=jnp.float32))
    xt = to_tensor(np.asarray(x))
    got = tqm.quant_matmul(xt, _port_qt(qt), out_dtype=torch.float32).numpy()
    _norm_close(got, want)


@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 5, 8])
def test_grouped_plain_matches_jax_and_qmm_plain(M, swiglu):
    """The grouped form's plain version (the grouped CUDA GEMV's reference)
    against the JAX quant_matmul at 8 bits with bf16 x (its grouped
    serving GEMV, in interpret mode; the suite's normalized 2e-2), and
    against qmm_plain in f32 out at 1e-4 (the same function, other
    rounding).  K = 1152 pads to 1280 (superblock 256), N = 384 (the JAX
    kernel tiles N by 128)."""
    rng = np.random.default_rng(90 + M + 10 * swiglu)
    N, K = 384, 1152
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=8,
                     meta_dtype=jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    u = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    pq = _port_qt(qt)
    kw = dict(nbits=8, group_size=128, shape=(N, K),
              superblock=pq.superblock, out_dtype=torch.float32,
              up=to_tensor(np.asarray(u)) if swiglu else None)
    xt = to_tensor(np.asarray(x))
    got = tqm.qmm_grouped_plain(xt, pq.packed, pq.scale, pq.zero, **kw)
    assert got.shape == (M, N) and got.dtype == torch.float32
    act = (jax.nn.silu(x.astype(jnp.float32)) * u.astype(jnp.float32)
           ).astype(jnp.bfloat16) if swiglu else x
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul(act, qt, out_dtype=jnp.float32))
    _norm_close(got.numpy(), want)
    plain = tqm.qmm_plain(xt, pq.packed, pq.scale, pq.zero, **kw).numpy()
    _norm_close(got.numpy(), plain, atol=1e-4)


@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_grouped_plain_low_widths_match_jax_indexed(nbits, M, swiglu):
    """The grouped form's plain version at 1/2/3/4 bits (one plane of
    128 + c, 3-bit codes recombined) against the JAX quant_matmul_indexed /
    quant_matmul_swiglu_indexed at bf16 x, M <= 8 (their grouped serving
    GEMV, _gemv_blockdiag, in interpret mode; the suite's normalized
    2e-2), and against qmm_plain in f32 out at 1e-4.  K = 2048 (superblock
    1024, the 7B sites' and every width's whole ring stages), N = 384."""
    rng = np.random.default_rng(150 + 10 * nbits + M + 100 * swiglu)
    N, K = 384, 2048
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=nbits,
                     meta_dtype=jnp.bfloat16)
    assert qt.superblock == 1024
    packed, scale, zero = _stack([qt])
    x, u = (jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16) for _ in range(2))
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock)
    with pltpu.force_tpu_interpret_mode():
        if swiglu:
            want = jqm.quant_matmul_swiglu_indexed(
                x, u, packed, scale, zero, jnp.int32(0),
                acc_dtype=jnp.bfloat16, out_dtype=jnp.float32, **kw)
        else:
            want = jqm.quant_matmul_indexed(
                x, packed, scale, zero, jnp.int32(0), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
    pq = _port_qt(qt)
    xt, ut = to_tensor(np.asarray(x)), to_tensor(np.asarray(u))
    args = dict(out_dtype=torch.float32, up=ut if swiglu else None, **kw)
    got = tqm.qmm_grouped_plain(xt, pq.packed, pq.scale, pq.zero, **args)
    assert got.shape == (M, N) and got.dtype == torch.float32
    _norm_close(got.numpy(), np.asarray(want))
    plain = tqm.qmm_plain(xt, pq.packed, pq.scale, pq.zero, **args).numpy()
    _norm_close(got.numpy(), plain, atol=1e-4)


#: per width, the smallest superblock of whole grouped ring stages (32
#: word rows of the round plane; 16 at 3 bits, beside 32 2-bit rows);
#: below 8 bits smaller ones fill a stage with several superblocks
_WHOLE_STAGE = {8: 128, 4: 256, 3: 512, 2: 512, 1: 1024}


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_grouped_routing_conditions(nbits):
    """bf16 activations, M <= 8, groups of a multiple of 64, a superblock
    of at most 1024 rows (each width's smallest of whole ring stages is
    accepted; half of it too below 8 bits, where a stage spans several
    superblocks, but not at 8 bits; one and a half of it refused), Np, K
    and x's row stride multiples of 8, 16-byte aligned operands; at 8 bits
    rounds that nest with the groups and whole stages, below 8 bits
    power-of-two groups and superblock: the grouped GEMV; f32 activations
    too (its float32 form), 4-row superblocks (1 and 3 bits at 128 rows)
    included; anything else keeps the CUDA-core GEMV."""
    sb = _WHOLE_STAGE[nbits]
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    meta = torch.zeros((2, 128), dtype=torch.bfloat16)

    def ok(x=x, nbits=nbits, group=64, superblock=sb, cols=128):
        packed = torch.zeros((superblock * nbits // 32, 128),
                             dtype=torch.int32)[:, :cols]
        return tqm._grouped_applies(x, packed, meta, meta, nbits, group,
                                    superblock)

    assert ok()
    assert ok(group=128, superblock=1024)
    # half a ring stage: a spanning stage of two superblocks below 8 bits
    assert ok(superblock=sb // 2) == (nbits != 8)
    # 1.5 ring stages (1-bit: 1536 rows, also past 1024; 8-bit: 192 rows,
    # 48 word rows)
    assert not ok(superblock=3 * sb // 2)
    assert ok(x=x.float())
    assert ok(x=x.float(), superblock=128)
    assert not ok(x=x.half())
    assert not ok(x=torch.zeros((9, 1024), dtype=torch.bfloat16))
    assert not ok(group=32)
    assert not ok(superblock=2048)
    assert not ok(cols=124)
    assert not ok(x=x[:, 1:1021])                   # K, alignment
    if nbits == 8:
        assert ok(nbits=4, superblock=128)          # half a 4-bit stage
        assert ok(group=64, superblock=384)         # 64-row groups nest
        assert not ok(group=128, superblock=384)    # rounds straddle groups
    if nbits == 4:      # whole stages, but not powers of two
        assert not ok(group=128, superblock=768)
        assert not ok(group=192, superblock=768)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_quant_matmul_indexed_f32(nbits, M):
    rng = np.random.default_rng(30 + nbits + M)
    L, N, K = 3, 256, 1152          # K pads to one 1024 superblock + 896
    qts = [jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)),
                       nbits=nbits) for _ in range(L)]
    packed, scale, zero = _stack(qts)
    x = rng.normal(size=(M, K)).astype(np.float32)
    layer = 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul_indexed(
            jnp.asarray(x), packed, scale, zero, jnp.int32(layer),
            nbits=nbits, group_size=128, shape=(N, K),
            superblock=qts[0].superblock))
    got = tqm.quant_matmul_indexed(
        torch.from_numpy(x), to_tensor(np.asarray(packed)),
        to_tensor(np.asarray(scale)), to_tensor(np.asarray(zero)), layer,
        nbits=nbits, group_size=128, shape=(N, K),
        superblock=qts[0].superblock).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_quant_matmul_swiglu_indexed_f32(nbits, M):
    rng = np.random.default_rng(40 + nbits + M)
    L, N, K = 2, 128, 768
    qts = [jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)),
                       nbits=nbits) for _ in range(L)]
    packed, scale, zero = _stack(qts)
    g = rng.normal(size=(M, K)).astype(np.float32)
    u = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul_swiglu_indexed(
            jnp.asarray(g), jnp.asarray(u), packed, scale, zero, jnp.int32(1),
            nbits=nbits, group_size=128, shape=(N, K),
            superblock=qts[0].superblock))
    got = tqm.quant_matmul_swiglu_indexed(
        torch.from_numpy(g), torch.from_numpy(u), to_tensor(np.asarray(packed)),
        to_tensor(np.asarray(scale)), to_tensor(np.asarray(zero)), 1,
        nbits=nbits, group_size=128, shape=(N, K),
        superblock=qts[0].superblock).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [2, 4])
def test_indexed_bf16_decode(nbits, swiglu):
    rng = np.random.default_rng(50 + nbits)
    N, K = 256, 2048
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=nbits, meta_dtype=jnp.bfloat16)
    packed, scale, zero = _stack([qt])
    x = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32)).astype(jnp.bfloat16)
    u = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32)).astype(jnp.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock)
    t_arrays = [to_tensor(np.asarray(a)) for a in (packed, scale, zero)]
    with pltpu.force_tpu_interpret_mode():
        if swiglu:
            want = jqm.quant_matmul_swiglu_indexed(
                x, u, packed, scale, zero, jnp.int32(0),
                acc_dtype=jnp.bfloat16, out_dtype=jnp.float32, **kw)
        else:
            want = jqm.quant_matmul_indexed(
                x, packed, scale, zero, jnp.int32(0), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
    xt, ut = to_tensor(np.asarray(x)), to_tensor(np.asarray(u))
    if swiglu:
        got = tqm.quant_matmul_swiglu_indexed(xt, ut, *t_arrays, 0,
                                              out_dtype=torch.float32, **kw)
    else:
        got = tqm.quant_matmul_indexed(xt, *t_arrays, 0,
                                       out_dtype=torch.float32, **kw)
    _norm_close(got.numpy(), np.asarray(want))


def _tile_case(kernel, nbits, M, meta, seed, superblock=None):
    """(port arguments, JAX output) of one bf16 multi-row call: N 256, K
    512 (superblock 512; ``superblock`` 128: K 896, seven of them), bf16 x
    (and SwiGLU operand), f32 out, the JAX kernel in interpret mode (its
    bf16 multi-row branch, _dequant_tile at acc_dtype = bf16)."""
    rng = np.random.default_rng(seed)
    N, K = 256, 896 if superblock == 128 else 512
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=nbits, meta_dtype=meta,
                     superblock=superblock)
    x, u = (jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16) for _ in range(2))
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock)
    packed, scale, zero = _stack([qt])
    with pltpu.force_tpu_interpret_mode():
        if kernel == "quant_matmul":
            want = jqm.quant_matmul(x, qt, out_dtype=jnp.float32)
        elif kernel == "quant_matmul_indexed":
            want = jqm.quant_matmul_indexed(
                x, packed, scale, zero, jnp.int32(0), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
        else:
            want = jqm.quant_matmul_swiglu_indexed(
                x, u, packed, scale, zero, jnp.int32(0),
                acc_dtype=jnp.bfloat16, out_dtype=jnp.float32, **kw)
    pq = _port_qt(qt)
    args = dict(x=to_tensor(np.asarray(x)), packed=pq.packed, scale=pq.scale,
                zero=pq.zero, out_dtype=torch.float32,
                up=(to_tensor(np.asarray(u))
                    if kernel == "quant_matmul_swiglu_indexed" else None),
                **kw)
    return args, np.asarray(want)


def _jax_swiglu(args):
    """The SwiGLU activation as the JAX kernel forms it (silu(g) * u in
    f32, rounded to bf16), from the port arguments' g and u."""
    g, u = (jnp.asarray(t.float().numpy()) for t in (args["x"], args["up"]))
    return to_tensor(np.asarray((jax.nn.silu(g) * u).astype(jnp.bfloat16)))


@pytest.mark.parametrize("meta", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kernel", ["quant_matmul", "quant_matmul_indexed",
                                    "quant_matmul_swiglu_indexed"])
def test_tile_plain_matches_jax_multi_row(kernel, nbits, M, meta):
    """The tile kernel's plain version against the JAX package's bf16
    multi-row kernels (_qmm_kernel, _qmm_kernel_stacked,
    _qmm_kernel_swiglu in interpret mode): the same bf16 weights (widths
    1-4 dequantized in bf16 op by op, 8 bits in f32 rounded once, f32 meta
    rounded to bf16 first), the same bf16 x, so only the f32 summation
    order differs (normalized atol 1e-5; measured about 3e-7).  Under
    SwiGLU the two frameworks' f32 silu part by an ulp on a few
    activations, which can flip their bf16 rounding: the product is held
    at 1e-5 on JAX's activation, the whole function (the port's own
    SwiGLU) at the suite's f32 2e-4."""
    args, want = _tile_case(kernel, nbits, M, meta,
                            seed=300 + 10 * nbits + M + (meta == jnp.float32))
    got = tqm.qmm_tile_plain(**args)
    assert got.shape == want.shape and got.dtype == torch.float32
    if args["up"] is None:
        _norm_close(got.numpy(), want, atol=1e-5)
        return
    _norm_close(got.numpy(), want, atol=2e-4)
    on_jax_act = tqm.qmm_tile_plain(**{**args, "x": _jax_swiglu(args),
                                       "up": None})
    _norm_close(on_jax_act.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("nbits", [1, 3])
@pytest.mark.parametrize("kernel", ["quant_matmul", "quant_matmul_indexed",
                                    "quant_matmul_swiglu_indexed"])
def test_tile_plain_matches_jax_multi_row_at_4_row_superblocks(kernel, nbits,
                                                               M):
    """The layouts of the tile kernel's pair form -- 1 and 3 bits (native
    planes) at superblocks of 128 rows, K over seven of them (the last
    pair-form stage of K partial) -- against the JAX package's bf16
    multi-row kernels, as test_tile_plain_matches_jax_multi_row (f32
    meta; normalized 1e-5, the SwiGLU product on JAX's activation)."""
    args, want = _tile_case(kernel, nbits, M, jnp.float32,
                            seed=700 + 10 * nbits + M, superblock=128)
    assert args["superblock"] == 128
    assert tqm._tile_applies(args["x"], args["packed"], args["scale"],
                             args["zero"], nbits, 128, 128)
    got = tqm.qmm_tile_plain(**args)
    x = args["x"] if args["up"] is None else _jax_swiglu(args)
    _norm_close(tqm.qmm_tile_plain(**{**args, "x": x, "up": None}).numpy(),
                want, atol=1e-5)
    _norm_close(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("meta", [jnp.float32, jnp.bfloat16])
def test_f32_multi_row_route_differs_from_jax_bf16(meta):
    """The fault the tile form repairs: the f32 dequantization
    (qmm_plain, the CUDA-core GEMM's function) is not the JAX package's
    bf16 multi-row function -- at 2 bits it is more than 1e-3 off
    (normalized) where the tile plain version agrees within 1e-5."""
    args, want = _tile_case("quant_matmul_indexed", 2, 32, meta, seed=290)
    scale = float(np.abs(want).max())
    old = tqm.qmm_plain(**args).numpy()
    new = tqm.qmm_tile_plain(**args).numpy()
    assert np.abs(old - want).max() / scale > 1e-3
    assert np.abs(new - want).max() / scale <= 1e-5


@pytest.mark.parametrize("kernel", ["quant_matmul", "quant_matmul_indexed",
                                    "quant_matmul_swiglu_indexed"])
def test_cpu_multi_row_route(kernel):
    """The port's wrappers on the CPU: bf16 x with M = 64 takes the tile
    plain version (the reference's bf16 multi-row function), f32 x the
    f32 plain version (the reference's acc_dtype = f32 function); bf16 x
    with M <= 8 keeps qmm_plain."""
    args, _ = _tile_case(kernel, 4, 64, jnp.bfloat16, seed=280)
    kw = {k: args[k] for k in ("nbits", "group_size", "shape", "superblock",
                               "out_dtype")}
    w = (args["packed"], args["scale"], args["zero"])

    def port(x, up):
        if kernel == "quant_matmul":
            qt = tq.QuantizedTensor(*w, kw["nbits"], kw["group_size"],
                                    kw["shape"], kw["superblock"])
            return tqm.quant_matmul(x, qt, out_dtype=torch.float32)
        stack = tuple(t[None] for t in w)
        if up is None:
            return tqm.quant_matmul_indexed(x, *stack, 0, **kw)
        return tqm.quant_matmul_swiglu_indexed(x, up, *stack, 0, **kw)

    x, up = args["x"], args["up"]
    assert torch.equal(port(x, up), tqm.qmm_tile_plain(x, *w, up=up, **kw))
    xf, uf = x.float(), (up.float() if up is not None else None)
    assert torch.equal(port(xf, uf), tqm.qmm_plain(xf, *w, up=uf, **kw))
    x8, u8 = x[:8], (up[:8] if up is not None else None)
    assert torch.equal(port(x8, u8), tqm.qmm_plain(x8, *w, up=u8, **kw))


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_tile_routing_conditions(nbits):
    """bf16 activations, 8 < M, Np, K and x's row stride multiples of 8,
    16-byte aligned operands and a layout the tile kernel takes (a
    superblock of whole 16-row groups whose round plane holds whole
    16-row steps: 1-bit and 3-bit superblocks of a multiple of 256 rows,
    2-bit of 128; or a 4-row superblock, 1 and 3 bits at 128 rows, in the
    pair form at groups of a multiple of 32; a ring that fits): the tile
    kernel; f32 activations too (its float32 form, chunks inside one
    group); anything else keeps the CUDA-core GEMM."""
    x = torch.zeros((64, 1024), dtype=torch.bfloat16)
    meta = torch.zeros((8, 128), dtype=torch.bfloat16)

    def ok(x=x, group=128, superblock=1024, cols=128, meta=meta):
        packed = torch.zeros((superblock * nbits // 32, 128),
                             dtype=torch.int32)[:, :cols]
        return tqm._tile_applies(x, packed, meta, meta, nbits, group,
                                 superblock)

    assert ok()
    assert ok(meta=meta.float())
    assert ok(x=x[:9])
    assert ok(x=torch.zeros((300, 1024), dtype=torch.bfloat16))
    assert ok(group=64, superblock=256)
    assert not ok(x=x[:8])
    assert ok(x=x.float())
    assert ok(x=x.float(), meta=meta.float())
    assert ok(x=x.float(), group=16, superblock=256)
    assert not ok(x=x.half())
    assert not ok(cols=124)
    assert not ok(x=x[:, 1:1021])                   # K, alignment
    assert not ok(group=8, superblock=256)
    assert ok(superblock=512) and ok(group=256, superblock=256)
    # the round plane of a 128-row superblock: 4 word rows at 1 and 3
    # bits (the pair form: four superblocks a stage), 8 at 2
    assert ok(superblock=128)
    assert ok(x=x.float(), superblock=128)
    assert ok(group=64, superblock=128) and ok(group=32, superblock=128)
    # a pair-form chunk (32 K rows) straddles 16-row groups
    assert ok(group=16, superblock=128) == (nbits not in (1, 3))


def _served_superblocks():
    """Every superblock ``pick_superblock`` and ``pick_superblock_padded``
    give at group 128, over K from 128 to 16384 in steps of 128."""
    from amq_tpu_torch.core.bitpack import (pick_superblock,
                                            pick_superblock_padded)
    found = set()
    for K in range(128, 16385, 128):
        found.add(pick_superblock(K, 128))
        found.add(pick_superblock_padded(K, 128)[0])
    return sorted(found)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_every_served_layout_takes_a_tensor_core_route(nbits, dtype):
    """Every layout the packers give at group 128 (superblocks of 128 to
    1024 rows, each width, bf16 and f32 x) at M 1, 8, 9 and 64, aligned
    operands: the grouped ring (M <= 8) or the tile kernel (8 < M) takes
    it -- no call reaches the CUDA-core GEMV or GEMM."""
    sbs = _served_superblocks()
    assert sbs == [128, 256, 512, 1024]
    for sb in sbs:
        Kp = 3 * sb
        packed = torch.zeros((Kp * nbits // 32, 256), dtype=torch.int32)
        meta = torch.zeros((Kp // 128, 256), dtype=torch.bfloat16)
        for M in (1, 8, 9, 64):
            x = torch.zeros((M, Kp), dtype=dtype)
            args = (x, packed, meta, meta, nbits, 128, sb)
            grouped, tile = tqm._grouped_applies(*args), tqm._tile_applies(*args)
            assert grouped or tile, (sb, M)
            assert (grouped, tile) == (M <= 8, M > 8), (sb, M)


def _attn_case(B, Hkv, G, hd, T, offsets, window=None, seed=0, L=3,
               cache_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv, G, hd)).astype(np.float32)
    kc = rng.normal(size=(L, B, Hkv, T, hd)).astype(cache_dtype)
    vc = rng.normal(size=(L, B, Hkv, T, hd)).astype(cache_dtype)
    kn = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    vn = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    offs = np.asarray(offsets, np.int32)
    layer = L - 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_attn(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(offs), jnp.int32(layer),
            window=window, out_dtype=jnp.float32))
    got = tda.decode_attention_indexed(
        *(to_tensor(a) for a in (q, kc, vc, kn, vn, offs)), layer,
        window=window, out_dtype=torch.float32).numpy()
    return want, got


@pytest.mark.parametrize("case", [
    dict(B=2, Hkv=4, G=2, hd=128, T=64, offsets=(5, 63)),
    # T=96 tiles by 32: offsets on tile edges and zero
    dict(B=3, Hkv=8, G=1, hd=128, T=96, offsets=(0, 32, 95), seed=1),
    dict(B=2, Hkv=4, G=2, hd=64, T=64, offsets=(10, 60), window=16, seed=2),
    dict(B=2, Hkv=2, G=4, hd=64, T=128, offsets=(1, 127), seed=3),
    # live contexts spanning several of the kernel's eight warp shares
    dict(B=4, Hkv=2, G=1, hd=128, T=512, offsets=(0, 1, 257, 511), seed=4),
    # G 8 and 16 (two and four groups of four heads), hd 64, with and
    # without a window
    dict(B=2, Hkv=2, G=8, hd=64, T=128, offsets=(5, 100), seed=5),
    dict(B=2, Hkv=2, G=8, hd=64, T=128, offsets=(5, 100), window=32, seed=6),
    dict(B=2, Hkv=1, G=16, hd=64, T=128, offsets=(17, 128), seed=7),
    dict(B=2, Hkv=1, G=16, hd=64, T=128, offsets=(17, 128), window=40,
         seed=8),
])
def test_decode_attention_matches_jax_kernel(case):
    want, got = _attn_case(**case)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_decode_attention_bf16_cache_matches_jax_kernel():
    """A bf16 cache (the serving default) widened to f32 in both."""
    want, got = _attn_case(B=3, Hkv=4, G=2, hd=128, T=256,
                           offsets=(1, 130, 255), seed=9,
                           cache_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Hkv, hd, nbytes, T, span", [
    (4, 128, 2, 4096, 256),      # Qwen2.5-7B's cache in the chat cells
    (8, 128, 2, 4096, 512),      # Mistral-7B's
    (32, 128, 2, 200, 1024),     # Llama-2-7B, B 1 generate: one split
    (32, 128, 2, 4096, 1024),
    (16, 128, 2, 200, 1024),     # a tp-2 rank of Llama-2-7B
    (2, 64, 2, 4096, 256),       # Qwen2-0.5B
    (8, 64, 2, 4096, 1024),
    (4, 128, 4, 4096, 128),      # float32 caches
    (1, 64, 4, 128, 128),
])
def test_decode_attention_split_plan(Hkv, hd, nbytes, T, span):
    """The split length comes from the model's shape alone (no B, no live
    length), a power of two of whole 16-key steps for every warp; the grid
    covers the cache's capacity, and T within one split is one block."""
    got, splits = tda.split_plan(Hkv, hd, T, nbytes)
    assert got == span and span & (span - 1) == 0 and 8 * 16 <= span <= 1024
    assert splits == -(-T // span) and (splits == 1) == (T <= span)
    assert "B" not in inspect.signature(tda.split_plan).parameters


@pytest.mark.parametrize("window", [None, 1, 100, 128, 129, 300])
@pytest.mark.parametrize("span", [128, 256])
def test_decode_attention_splits_cover_the_live_keys(span, window):
    """A row's splits cut [t_lo, off) from its own window start every
    ``span`` keys: contiguous, in order, none empty, none longer than
    ``span``, never more than the grid holds, exactly the keys the plain
    version attends to."""
    T = 1024
    for off in (0, 1, span - 1, span, span + 1, 2 * span + 7, T - 1, T,
                T + 5):
        ranges = tda.split_ranges(off, window, span, T)
        live = min(off, T)
        t_lo = max(0, live - window + 1) if window else 0
        keys = [t for lo, hi in ranges for t in range(lo, hi)]
        assert keys == list(range(t_lo, live)), (off, window)
        assert all(0 < hi - lo <= span for lo, hi in ranges)
        assert all(lo == t_lo + i * span for i, (lo, _) in enumerate(ranges))
        assert len(ranges) <= -(-T // span)


#: (B, Hkv, G, hd, T, offsets, window); float32 caches, so span 128:
#: offsets at 0, 1, a split boundary - 1, the boundary, + 1, the cache's end
SPLIT_CASES = [
    (6, 1, 2, 128, 512, (0, 1, 127, 128, 129, 511), None),
    (2, 4, 7, 128, 1024, (700, 1000), None),            # qwen's G, one pass
    (2, 8, 4, 128, 1024, (600, 1024), None),            # mistral's
    (3, 2, 4, 64, 512, (130, 300, 512), 200),           # window across splits
    (2, 2, 16, 64, 384, (129, 383), 129),               # G 16, window 129
    (2, 4, 1, 128, 256, (77, 256), 64),                 # G 1, window in one
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"split{i}" for i in range(len(SPLIT_CASES))])
def test_decode_attention_split_order_matches_plain_and_jax(case):
    """The kernel's split-and-merge order (``decode_attention_split_plain``)
    against the plain version and the JAX kernel, float32, at multi-split
    lengths; each row's result equals the row alone (no dependence on B)."""
    B, Hkv, G, hd, T, offsets, window = case
    want, got = _attn_case(B, Hkv, G, hd, T, offsets, window=window,
                           seed=B + T)
    rng = np.random.default_rng(B + T)
    q = rng.normal(size=(B, Hkv, G, hd)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, B, Hkv, T, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(B, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    args = [to_tensor(a) for a in (q, kc[2], vc[2], kn, vn,
                                   np.asarray(offsets, np.int32))]
    assert tda.split_plan(Hkv, hd, T, 4)[1] > 1
    split = tda.decode_attention_split_plain(*args, window=window,
                                             out_dtype=torch.float32)
    np.testing.assert_allclose(split.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(split.numpy(), got, rtol=2e-4, atol=2e-4)
    for b in range(B):
        alone = tda.decode_attention_split_plain(
            *(a[b:b + 1] for a in args), window=window,
            out_dtype=torch.float32)
        assert torch.equal(alone, split[b:b + 1]), b


def test_cpu_wrappers_do_not_count_launches():
    from amq_tpu_torch import ops
    ops.reset_launch_counts()
    test_quant_matmul_f32(4, 1)
    test_decode_attention_matches_jax_kernel(
        dict(B=1, Hkv=2, G=1, hd=64, T=32, offsets=(3,)))
    assert set(ops.launch_counts().values()) == {0}
