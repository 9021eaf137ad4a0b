"""Port core (bitpack, HQQ quantize) held to the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from amq_tpu.core import bitpack as jbp
from amq_tpu.core import quantize as jq
from amq_tpu_torch.core import bitpack as tbp
from amq_tpu_torch.core import quantize as tq

from test_torch_slice import torch_one_thread  # noqa: F401
from amq_tpu_torch.models.convert import to_tensor


def _words_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("K,block", [(512, 256), (1024, 1024)])
def test_pack_both_directions_bit_exact(nbits, K, block):
    rng = np.random.default_rng(nbits * 7 + K)
    codes = rng.integers(0, 2**nbits, (K, 96)).astype(np.uint32)
    j_words = np.asarray(jbp.pack(jnp.asarray(codes), nbits, block))
    t_words = tbp.pack(torch.from_numpy(codes.astype(np.int64)), nbits, block)
    np.testing.assert_array_equal(_words_np(t_words), j_words)
    # a port pack unpacks under JAX, and a JAX pack under the port
    back_j = np.asarray(jbp.unpack(jnp.asarray(_words_np(t_words)), nbits, block))
    back_t = tbp.unpack(to_tensor(j_words), nbits, block).numpy()
    np.testing.assert_array_equal(back_j, codes)
    np.testing.assert_array_equal(back_t, codes.astype(np.int32))


@pytest.mark.parametrize("K", [256, 1024, 11008, 13824])
def test_superblock_choice_matches(K):
    assert tbp.pick_superblock_padded(K) == jbp.pick_superblock_padded(K)
    if K % 128 == 0:
        assert tbp.pick_superblock(K) == jbp.pick_superblock(K)


def _jax_qt_to_port(qt) -> tq.QuantizedTensor:
    return tq.QuantizedTensor(
        packed=to_tensor(np.asarray(qt.packed)),
        scale=to_tensor(np.asarray(qt.scale)),
        zero=to_tensor(np.asarray(qt.zero)),
        nbits=qt.nbits, group_size=qt.group_size, shape=tuple(qt.shape),
        superblock=qt.superblock)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_dequantize_and_container_bit_exact(nbits, meta):
    """Same packed/scale/zero arrays -> identical dequantized weights, in
    the kernel orientation and the original one; to_container repacks to
    the same words the JAX package writes.  K = 1152 pads to a 1024
    superblock (K-padded storage)."""
    rng = np.random.default_rng(nbits)
    W = rng.normal(size=(160, 1152)).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(W), nbits=nbits,
                      meta_dtype=getattr(jnp, meta))
    tqt = _jax_qt_to_port(jqt)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.dequantize_kn(jqt, dt_j).astype(jnp.float32))
        got = tq.dequantize_kn(tqt, dt_t).float().numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)))
    for cont in (4, 8):
        if cont < nbits:
            continue
        want = np.asarray(jq.to_container(jqt, cont).packed)
        got = _words_np(tq.to_container(tqt, cont).packed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
def test_hqq_quantize_matches_jax(nbits):
    """scale/zero agree to float32 rounding (rtol 1e-5 / atol 1e-4 on the
    zero point, in units of quantization steps); codes may differ where
    W * scale + zero lands within float32 rounding of a .5 boundary, so at
    most 0.1% of the codes, each by one step."""
    rng = np.random.default_rng(10 + nbits)
    W = (rng.normal(size=(256, 768)) * 0.05).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(W), nbits=nbits)
    tqt = tq.quantize(torch.from_numpy(W), nbits=nbits)
    assert tqt.packed.shape == jqt.packed.shape
    assert tqt.superblock == jqt.superblock
    np.testing.assert_allclose(tqt.scale.numpy(), np.asarray(jqt.scale),
                               rtol=1e-5)
    np.testing.assert_allclose(tqt.zero.numpy(), np.asarray(jqt.zero),
                               rtol=1e-5, atol=1e-4)
    cj = np.asarray(jbp.unpack(jqt.packed, nbits, jqt.superblock)).astype(np.int64)
    ct = tbp.unpack(tqt.packed, nbits, tqt.superblock).numpy().astype(np.int64)
    diff = np.abs(cj - ct)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_quantize_bf16_meta_and_explicit_superblock():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(128, 512)).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(W), nbits=4, meta_dtype=jnp.bfloat16,
                      superblock=256)
    tqt = tq.quantize(torch.from_numpy(W), nbits=4, meta_dtype=torch.bfloat16,
                      superblock=256)
    assert tqt.scale.dtype == torch.bfloat16 and tqt.superblock == 256
    np.testing.assert_allclose(tqt.scale.float().numpy(),
                               np.asarray(jqt.scale.astype(jnp.float32)),
                               rtol=1e-2)
    np.testing.assert_allclose(tq.dequantize(tqt).numpy(),
                               np.asarray(jq.dequantize(jqt)), atol=0.05)


def _unpack_int64_route(words: torch.Tensor, nbits: int, group_size: int):
    """The port's earlier unpack (int64 words, two torch.stack per plane),
    kept here as the reference of the int32 rewrite."""
    def group(w, b):
        G, rows, N = w.shape
        parts = []
        for p in range(16 // b):
            lo = (w >> (b * p)) & (2**b - 1)
            hi = (w >> (16 + b * p)) & (2**b - 1)
            parts.append(torch.stack([lo, hi], dim=3))
        return torch.stack(parts, dim=1).movedim(4, 3).reshape(
            G, group_size, N)

    rows = tbp.packed_rows(group_size, nbits)
    G = words.shape[0] // rows
    w = words.to(torch.int64).reshape(G, rows, -1) & (2**32 - 1)
    if nbits in tbp._PLANE_SPLIT:
        hb, lb = tbp._PLANE_SPLIT[nbits]
        hr = tbp.packed_rows(group_size, hb)
        out = (group(w[:, :hr], hb) << lb) | group(w[:, hr:], lb)
    else:
        out = group(w, nbits)
    return out.reshape(G * group_size, -1)


@pytest.mark.parametrize("nbits", tbp.SUPPORTED_BITS)
def test_int32_unpack_and_dequantize_bit_equal(nbits):
    """The int32 unpack equals the int64 route and the JAX unpack at every
    width (every bit pattern of the words, bit 31 included); dequantize_kn
    in f32 and bf16 equals the JAX dequantize_kn on the same arrays, with
    a K pad (1280 -> 1152 rows) and an N cut (96 -> 90 columns)."""
    rng = np.random.default_rng(40 + nbits)
    sb, Kp, Np = 256, 1280, 96
    words = rng.integers(0, 2**32, (Kp * nbits // 32, Np), dtype=np.uint64
                         ).astype(np.uint32)
    tw = to_tensor(words)
    got = tbp.unpack(tw, nbits, sb)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), _unpack_int64_route(tw, nbits, sb))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.unpack(jnp.asarray(words), nbits, sb)))
    scale = (rng.random((Kp // 128, Np)) * 0.02).astype(np.float32)
    zero = (rng.random((Kp // 128, Np)) * (2**nbits - 1)).astype(np.float32)
    for meta in (jnp.float32, jnp.bfloat16):
        jqt = jq.QuantizedTensor(
            packed=jnp.asarray(words), scale=jnp.asarray(scale).astype(meta),
            zero=jnp.asarray(zero).astype(meta), nbits=nbits, group_size=128,
            shape=(90, 1152), superblock=sb)
        tqt = _jax_qt_to_port(jqt)
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jq.dequantize_kn(jqt, dt_j).astype(jnp.float32))
            got_w = tq.dequantize_kn(tqt, dt_t)
            assert got_w.dtype == dt_t and got_w.shape == (1152, 90)
            np.testing.assert_array_equal(got_w.float().numpy(), want)
