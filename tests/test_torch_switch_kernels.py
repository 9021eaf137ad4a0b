"""The plain versions of the decode-switch kernels held to the JAX package
on the CPU, and the predicates that route the switches.

Under ``AMQ_PIPE`` the JAX package's pipelined decode GEMVs
(``_qmm_kernel_stacked_pipe``, ``_qmm_kernel_swiglu_pipe``) compute the
grouped form ``_gemv_dot_codes``; the port's pipelined grouped GEMV is held
on the card to ``qmm_grouped_plain``, which is held here to those kernels
in interpret mode.  Under ``AMQ_MLP_KERNEL`` the JAX package's one-call
MLP (``_qmm_kernel_mlp``) runs ``_gemv_blockdiag`` for both products; the
port's one-launch MLP is held on the card to ``qmm_mlp_grouped_plain``,
held here to that kernel.

Tolerance: the JAX suite's bf16 decode GEMV, atol 2e-2 on outputs
normalized by their largest magnitude (``tests/test_quant_matmul.py``).
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


def _norm_close(got, want, atol=2e-2):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _stack(qts):
    return tuple(jnp.stack([getattr(t, f) for t in qts])
                 for f in ("packed", "scale", "zero"))


def _t(arrays):
    return [to_tensor(np.asarray(a)) for a in arrays]


#: K over three 1024-row superblocks (T = 8 groups of 128 each, the JAX
#: switch's condition), so the pipelined kernel dots tile k - 1 while it
#: extracts tile k; a shape no other test traces, so the JAX call is traced
#: here, under the switch
PIPE_N, PIPE_K = 256, 3072


@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_grouped_plain_matches_jax_pipe_kernel(nbits, M, swiglu, monkeypatch):
    """qmm_grouped_plain (the pipelined grouped GEMV's reference) against
    the JAX quant_matmul_indexed / quant_matmul_swiglu_indexed with
    ``_PIPE_DEFAULT`` on (its ``_gemv_dot_codes`` kernel, in interpret
    mode), layer 1 of a two-layer stack, bf16 x and meta, f32 out."""
    monkeypatch.setattr(jqm, "_PIPE_DEFAULT", 1)
    traced = []
    pipe_kernel = jqm._qmm_kernel_stacked_pipe

    def spy(*a, **k):
        traced.append(k["nbits"])
        return pipe_kernel(*a, **k)

    monkeypatch.setattr(jqm, "_qmm_kernel_stacked_pipe", spy)
    rng = np.random.default_rng(200 + 10 * nbits + M + 100 * swiglu)
    qts = [jq.quantize(jnp.asarray(rng.normal(size=(PIPE_N, PIPE_K)).astype(
        np.float32) * 0.02), nbits=nbits, meta_dtype=jnp.bfloat16)
        for _ in range(2)]
    assert qts[0].superblock == 1024
    stack = _stack(qts)
    x, u = (jnp.asarray(rng.normal(size=(M, PIPE_K)).astype(np.float32)
                        ).astype(jnp.bfloat16) for _ in range(2))
    kw = dict(nbits=nbits, group_size=128, shape=(PIPE_N, PIPE_K),
              superblock=1024)
    with pltpu.force_tpu_interpret_mode():
        if swiglu:
            want = jqm.quant_matmul_swiglu_indexed(
                x, u, *stack, jnp.int32(1), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
        else:
            want = jqm.quant_matmul_indexed(
                x, *stack, jnp.int32(1), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
    assert traced and set(traced) == {nbits}    # the pipelined kernel ran
    packed, scale, zero = (t[1] for t in _t(stack))
    got = tqm.qmm_grouped_plain(
        to_tensor(np.asarray(x)), packed, scale, zero,
        up=to_tensor(np.asarray(u)) if swiglu else None,
        out_dtype=torch.float32, **kw)
    assert got.shape == (M, PIPE_N)
    _norm_close(got.numpy(), np.asarray(want))


MLP_HID, MLP_INTER, MLP_SB = 512, 384, 128


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_mlp_grouped_plain_matches_jax_mlp_kernel(nbits, M):
    """qmm_mlp_grouped_plain (the one-launch MLP's reference) against the
    JAX quant_matmul_mlp_indexed in interpret mode, layer 1 of a two-layer
    stack; the intermediate width 384 crosses down's superblocks, and the
    JAX kernel keeps gateup in a bf16 scratch summed per superblock where
    the plain version rounds once."""
    rng = np.random.default_rng(300 + 10 * nbits + M)

    def stack(n, k):
        return _stack([jq.quantize(
            jnp.asarray(rng.normal(size=(n, k)).astype(np.float32) * 0.05),
            nbits=nbits, group_size=128, superblock=MLP_SB,
            meta_dtype=jnp.bfloat16) for _ in range(2)])

    gu, dn = stack(2 * MLP_INTER, MLP_HID), stack(MLP_HID, MLP_INTER)
    x = jnp.asarray(rng.normal(size=(M, MLP_HID)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    kw = dict(nbits=nbits, group_size=128, gu_shape=(2 * MLP_INTER, MLP_HID),
              d_shape=(MLP_HID, MLP_INTER), superblock=MLP_SB)
    with pltpu.force_tpu_interpret_mode():
        want = jqm.quant_matmul_mlp_indexed(x, *gu, *dn, jnp.int32(1),
                                            out_dtype=jnp.float32, **kw)
    got = tqm.qmm_mlp_grouped_plain(
        to_tensor(np.asarray(x)), *(t[1] for t in _t(gu)),
        *(t[1] for t in _t(dn)), out_dtype=torch.float32, **kw)
    assert got.shape == (M, MLP_HID)
    _norm_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_pipe_routing_conditions(nbits, monkeypatch):
    """One predicate routes the AMQ_PIPE switch: the JAX package's
    conditions (switch on, M <= 8, bf16 x, T = superblock / group >= 8, a
    width other than 8) and the grouped ring's (its layouts, strides and
    alignment).  A call the switch selects but the ring does not take
    stays where the wrapper sends it without the switch."""
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    meta = torch.zeros((16, 256), dtype=torch.bfloat16)

    def applies(x=x, group=128, superblock=1024, cols=256, switch=1):
        monkeypatch.setattr(tqm, "_PIPE_DEFAULT", switch)
        packed = torch.zeros((superblock * nbits // 32, 256),
                             dtype=torch.int32)[:, :cols]
        return tqm._pipe_applies(x, packed, meta, meta, nbits, group,
                                 superblock)

    if nbits == 8:                      # the JAX switch leaves 8 bits
        assert not applies()
        return
    assert applies()
    assert not applies(switch=0)
    assert not applies(group=256)                   # T = 4
    # T = 8 in a 512-row superblock: whole ring stages at 2, 3 and 4 bits,
    # half a stage at 1 bit, which the ring refuses
    assert applies(group=64, superblock=512) == (nbits != 1)
    assert not applies(x=x.float())
    assert not applies(x=torch.zeros((9, 1024), dtype=torch.bfloat16))
    assert not applies(cols=124)                    # Np % 8
    assert not applies(x=x[:, 1:1021])              # K, alignment

    # the wrappers follow it, on the CPU too (where the pipelined wrappers
    # take the plain version)
    routed = []
    for name in ("quant_matmul_indexed_pipe",
                 "quant_matmul_swiglu_indexed_pipe"):
        monkeypatch.setattr(tqm, name,
                            lambda *a, _n=name, **k: routed.append(_n))
    monkeypatch.setattr(tqm, "_PIPE_DEFAULT", 1)
    stack = torch.zeros((1, 1024 * nbits // 32, 256), dtype=torch.int32)
    mstack = torch.zeros((1, 8, 256), dtype=torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(256, 1024), superblock=1024)
    tqm.quant_matmul_indexed(x, stack, mstack, mstack, 0, **kw)
    tqm.quant_matmul_swiglu_indexed(x, x, stack, mstack, mstack, 0, **kw)
    assert routed == ["quant_matmul_indexed_pipe",
                      "quant_matmul_swiglu_indexed_pipe"]
    out = tqm.quant_matmul_indexed(x.float(), stack, mstack, mstack, 0, **kw)
    assert routed == ["quant_matmul_indexed_pipe",
                      "quant_matmul_swiglu_indexed_pipe"]
    assert out.shape == (8, 256) and out.dtype == torch.float32


def test_mlp_routing_conditions():
    """The one-launch MLP takes bf16 x, M <= 8 and layers of both stacks
    the grouped ring takes (a superblock of whole ring stages, Np a
    multiple of 8, aligned operands); otherwise the MLP switch leaves the
    layer to the separate kernels."""
    def layer(rows, cols, groups=8):
        return (torch.zeros((rows, cols), dtype=torch.int32),
                torch.zeros((groups, cols), dtype=torch.bfloat16),
                torch.zeros((groups, cols), dtype=torch.bfloat16))

    x = torch.zeros((4, 1024), dtype=torch.bfloat16)
    gu, dn = layer(128, 2048), layer(128, 1024)
    assert tqm._mlp_applies(x, gu, dn, 4, 128, 1024)
    assert not tqm._mlp_applies(x.float(), gu, dn, 4, 128, 1024)
    assert not tqm._mlp_applies(torch.zeros((9, 1024), dtype=torch.bfloat16),
                                gu, dn, 4, 128, 1024)
    assert not tqm._mlp_applies(x, gu, dn, 4, 128, 128)  # half a stage
    assert not tqm._mlp_applies(x, gu, layer(128, 1028)[:1] + dn[1:], 4, 128,
                                1024)                     # down's Np % 8
    shifted = torch.zeros(128 * 1024 + 1, dtype=torch.int32)[1:]
    assert not tqm._mlp_applies(x, gu, (shifted.view(128, 1024),) + dn[1:],
                                4, 128, 1024)       # down's alignment
