"""The float32 forms of rows 1, 2 and 4 (f32 activations on tensor cores)
held to the JAX package's f32 functions on the CPU.

The grouped ring's float32 GEMV (``csrc/quant_matmul_f32.cu``, M <= 8) and
the tile kernel's float32 form (``qmm_tile_f32_kernel``, 8 < M) compute
the f32 function as exact codes against x split once into three bf16
parts, with each group's scale and zero applied in f32 afterwards.  Their
arithmetic's plain version, ``ops.quant_matmul.qmm_exact_plain`` (the
split, exact codes, one correction per piece of K rows in the kernel's
order: a ring stage's round at M <= 8, a tile chunk above), is held here
to ``quant_matmul``, ``quant_matmul_indexed`` and
``quant_matmul_swiglu_indexed`` of the JAX package with f32 x (their
Pallas kernels in interpret mode, as ``tests/test_torch_ops.py`` runs
them) at the JAX suite's f32 tolerance, rtol = atol = 2e-4, and to the
port's f32 plain version ``qmm_plain`` at 2e-4 of the largest output.
The kernels themselves are held to both on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from amq_tpu.core import quantize as jq
from amq_tpu.ops import quant_matmul as jqm
from amq_tpu_torch.models.convert import to_tensor
from amq_tpu_torch.ops import quant_matmul as tqm

from test_torch_slice import torch_one_thread  # noqa: F401

TOL = 2e-4
META = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _piece(nbits, M, group, superblock, meta_bf16):
    """K rows per correction: at M <= 8 one round of a grouped ring stage
    (or of a superblock, where a stage spans several; at 4-row
    superblocks a round pair, the pair form's step), above M = 8 one
    chunk of the tile kernel's float32 form (2 ns rows: 32 in the pair
    form)."""
    if M > 8:
        return 2 * tqm._tile_ns(nbits, group, superblock, meta_bf16, True)
    if tqm._pair_layout(nbits, superblock):
        return 16
    rows = tqm._grouped_stage_rows(nbits)
    return 2 * min(rows, tqm._grouped_round_rows(nbits, superblock))


def _weights(rng, nbits, N, K, meta, L=1, superblock=None):
    qts = [jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                   * 0.02), nbits=nbits,
                       meta_dtype=META[meta], superblock=superblock)
           for _ in range(L)]
    stack = tuple(jnp.stack([getattr(t, f) for t in qts])
                  for f in ("packed", "scale", "zero"))
    return qts[0], stack, [to_tensor(np.asarray(a)) for a in stack]


def _exact(x, arrays, layer, nbits, shape, superblock, up=None, parts=3,
           meta="f32"):
    packed, scale, zero = (a[layer] for a in arrays)
    return tqm.qmm_exact_plain(
        x, packed, scale, zero, nbits=nbits, group_size=128, shape=shape,
        superblock=superblock, out_dtype=torch.float32, up=up, parts=parts,
        piece=_piece(nbits, x.shape[0], 128, superblock, int(meta == "bf16")))


def _plain(x, arrays, layer, nbits, shape, superblock, up=None):
    packed, scale, zero = (a[layer] for a in arrays)
    return tqm.qmm_plain(x, packed, scale, zero, nbits=nbits, group_size=128,
                         shape=shape, superblock=superblock,
                         out_dtype=torch.float32, up=up)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("meta", ["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 5, 8, 64])
@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
def test_exact_form_matches_jax_quant_matmul(nbits, M, meta):
    """``quant_matmul`` with f32 x (3-bit in native planes): the float32
    forms' arithmetic against the JAX kernel and qmm_plain."""
    rng = np.random.default_rng(500 + 10 * nbits + M + (meta == "bf16"))
    N, K = 256, 512
    qt, _, arrays = _weights(rng, nbits, N, K, meta)
    x = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qt))
    xt = torch.from_numpy(x)
    got = _exact(xt, arrays, 0, nbits, (N, K), qt.superblock, meta=meta)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    plain = _plain(xt, arrays, 0, nbits, (N, K), qt.superblock)
    assert _norm_err(got, plain) <= TOL
    # the wrapper's CPU route is qmm_plain itself
    assert torch.equal(tqm.quant_matmul(xt, tqm.QuantizedTensor(
        *(a[0] for a in arrays), nbits, 128, (N, K), qt.superblock)), plain)


@pytest.mark.parametrize("M", [1, 64])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_exact_form_matches_jax_indexed(nbits, M):
    """``quant_matmul_indexed`` with f32 x, layer 1 of a stack, K 1152
    padded to one 1024 superblock and a partial second."""
    rng = np.random.default_rng(540 + nbits + M)
    N, K = 128, 1152
    qt, (packed, scale, zero), arrays = _weights(rng, nbits, N, K, "f32", L=2)
    x = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul_indexed(
            jnp.asarray(x), packed, scale, zero, jnp.int32(1), nbits=nbits,
            group_size=128, shape=(N, K), superblock=qt.superblock))
    xt = torch.from_numpy(x)
    got = _exact(xt, arrays, 1, nbits, (N, K), qt.superblock)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert _norm_err(got, _plain(xt, arrays, 1, nbits, (N, K),
                                 qt.superblock)) <= TOL


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
def test_exact_form_matches_jax_swiglu_indexed(nbits, M):
    """``quant_matmul_swiglu_indexed`` with f32 gate and up: SwiGLU in f32
    (the split pass's), then the split."""
    rng = np.random.default_rng(560 + nbits + M)
    N, K = 128, 768
    qt, (packed, scale, zero), arrays = _weights(rng, nbits, N, K, "bf16")
    g, u = (rng.normal(size=(M, K)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul_swiglu_indexed(
            jnp.asarray(g), jnp.asarray(u), packed, scale, zero, jnp.int32(0),
            nbits=nbits, group_size=128, shape=(N, K),
            superblock=qt.superblock))
    gt, ut = torch.from_numpy(g), torch.from_numpy(u)
    got = _exact(gt, arrays, 0, nbits, (N, K), qt.superblock, up=ut,
                 meta="bf16")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert _norm_err(got, _plain(gt, arrays, 0, nbits, (N, K), qt.superblock,
                                 up=ut)) <= TOL


@pytest.mark.parametrize("M", [1, 5, 64])
@pytest.mark.parametrize("nbits", [2, 3])
def test_exact_form_at_owq_down_layout(nbits, M):
    """OWQ's down layout: superblocks of 256 rows at 2 and 3 bits (a ring
    stage spans several: corrections per superblock round), K over eleven
    superblocks, f32 meta."""
    rng = np.random.default_rng(580 + nbits + M)
    N, K = 128, 11 * 256
    qt, (packed, scale, zero), arrays = _weights(rng, nbits, N, K, "f32",
                                                 superblock=256)
    assert qt.superblock == 256
    x = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul_indexed(
            jnp.asarray(x), packed, scale, zero, jnp.int32(0), nbits=nbits,
            group_size=128, shape=(N, K), superblock=256))
    xt = torch.from_numpy(x)
    got = _exact(xt, arrays, 0, nbits, (N, K), 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert _norm_err(got, _plain(xt, arrays, 0, nbits, (N, K), 256)) <= TOL
    # the float32 GEMV takes the layout (the spanning kernel's SPS forms)
    assert tqm._grouped_applies(xt[:1], *(a[0] for a in arrays), nbits, 128,
                                256)


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("nbits", [1, 3])
def test_exact_pair_form_matches_jax_quant_matmul(nbits, M):
    """The 4-row superblocks (1 and 3 bits at 128 rows, 3-bit in native
    planes), K over seven superblocks: the float32 pair forms' arithmetic
    -- round-pair corrections at M <= 8 (the grouped ring's), 32-row
    chunks above (the tile kernel's) -- against the JAX kernel and
    qmm_plain; both routes take the layout."""
    rng = np.random.default_rng(640 + 10 * nbits + M)
    N, K = 256, 7 * 128
    qt, _, arrays = _weights(rng, nbits, N, K, "f32", superblock=128)
    assert qt.superblock == 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qt))
    xt = torch.from_numpy(x)
    assert _piece(nbits, M, 128, 128, 0) == (16 if M <= 8 else 32)
    got = _exact(xt, arrays, 0, nbits, (N, K), 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert _norm_err(got, _plain(xt, arrays, 0, nbits, (N, K), 128)) <= TOL
    w = tuple(a[0] for a in arrays)
    assert (tqm._grouped_applies(xt, *w, nbits, 128, 128)
            or tqm._tile_applies(xt, *w, nbits, 128, 128))


@pytest.mark.parametrize("M", [1, 64])
def test_one_bf16_part_misses_the_f32_tolerance(M, record_property):
    """Why x takes three parts: with one bf16 part (x rounded to bf16) the
    result misses 2e-4 of the largest output; two parts meet it (the error
    is reported, ``two_part_err``), three meet it by far more -- the margin
    the token-exact float32 gates of 32-layer decoding rest on."""
    rng = np.random.default_rng(600 + M)
    N, K, nbits = 256, 2048, 4
    qt, _, arrays = _weights(rng, nbits, N, K, "f32")
    xt = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    plain = _plain(xt, arrays, 0, nbits, (N, K), qt.superblock)
    err = {parts: _norm_err(_exact(xt, arrays, 0, nbits, (N, K),
                                   qt.superblock, parts=parts), plain)
           for parts in (1, 2, 3)}
    record_property("two_part_err", err[2])
    print(f"M={M}: one part {err[1]:.3e}, two {err[2]:.3e}, three "
          f"{err[3]:.3e} (of the largest output)")
    assert err[1] > TOL
    assert err[2] <= TOL and err[3] <= TOL
    assert err[3] < err[2] < err[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_holds_x(seed):
    """The three bf16 parts sum back to x (each difference exact in f32),
    one and two parts do not."""
    rng = np.random.default_rng(620 + seed)
    x = torch.from_numpy((rng.normal(size=(3, 4096))
                          * 10.0 ** rng.integers(-6, 6, size=(3, 4096))
                          ).astype(np.float32))
    parts = tqm.split_f32_plain(x)
    assert parts.shape == (3, 3, 4096)
    assert torch.equal(parts.to(torch.bfloat16).float(), parts)
    assert torch.equal((parts[0] + parts[1]) + parts[2], x)
    assert not torch.equal(parts[0], x)
    assert not torch.equal(parts[0] + parts[1], x)
