"""The grouped decode GEMV at superblocks smaller than one ring stage.

Below 8 bits the port's grouped ring (``csrc/qmm_grouped.cuh``) fills a
stage of 32 word rows (16 at 3 bits) with several whole superblocks when
one superblock's round plane holds fewer rows: every width's 128-row
superblock, 256 rows at 1-3 bits, 512 at 1 bit -- OWQ's compacted down
projection (Kp 11008 in superblocks of 256) among them.  The JAX package
takes its grouped serving GEMV (``_gemv_blockdiag``) at every superblock;
here the port's plain version of that form, ``qmm_grouped_plain`` (the
spanning kernel's reference on the card), is held to the JAX
``quant_matmul`` in interpret mode at such layouts, and the routing and
the stage plan are checked in Python.  The kernel itself is held to the
plain version on a card (``tests/test_torch_cuda.py -k spanning``,
``chip_smoke.py``).

Tolerance: the JAX suite's bf16 decode GEMV, atol 2e-2 on outputs
normalized by their largest magnitude (``tests/test_quant_matmul.py``).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from amq_tpu.core import quantize as jq
from amq_tpu.ops import quant_matmul as jqm
from amq_tpu_torch.core import bitpack
from amq_tpu_torch.models.config import get_config
from amq_tpu_torch.models.convert import to_tensor
from amq_tpu_torch.ops import quant_matmul as tqm
from amq_tpu_torch.quantization.owq import compute_n_out

from test_torch_slice import torch_one_thread  # noqa: F401


def _norm_close(got, want, atol=2e-2):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _lane_pad(qt, Np):
    """The JAX tensor with its N axis padded to ``Np`` lanes (zero codes
    and meta past N, as the stacked serving layout pads it)."""
    pad = ((0, 0), (0, Np - qt.packed.shape[1]))
    return dataclasses.replace(qt, packed=jnp.pad(qt.packed, pad),
                               scale=jnp.pad(qt.scale, pad),
                               zero=jnp.pad(qt.zero, pad))


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("superblock,Kp", [(256, 768), (128, 384)])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_grouped_plain_small_superblocks_match_jax(nbits, superblock, Kp, M):
    """``qmm_grouped_plain`` against the JAX ``quant_matmul`` at bf16 x
    and M <= 8 (its ``_gemv_blockdiag``, interpret mode) at a small
    superblock -- 256 rows with an odd count of superblocks (Kp 768),
    128 rows (Kp 384) -- N 200 lane-padded to 256, bf16 and f32 meta;
    and against ``qmm_plain`` in f32 out at 1e-4."""
    rng = np.random.default_rng(500 + 10 * nbits + M + superblock)
    N, Np = 200, 256
    for meta in (jnp.bfloat16, jnp.float32):
        qt = _lane_pad(jq.quantize(
            jnp.asarray(rng.normal(size=(N, Kp)).astype(np.float32) * 0.02),
            nbits=nbits, meta_dtype=meta, superblock=superblock), Np)
        x = jnp.asarray(rng.normal(size=(M, Kp)).astype(np.float32)).astype(
            jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jqm.quant_matmul(x, qt, out_dtype=jnp.float32))
        packed, scale, zero = (to_tensor(np.asarray(a))
                               for a in (qt.packed, qt.scale, qt.zero))
        kw = dict(nbits=nbits, group_size=128, shape=(N, Kp),
                  superblock=superblock, out_dtype=torch.float32)
        xt = to_tensor(np.asarray(x))
        got = tqm.qmm_grouped_plain(xt, packed, scale, zero, **kw)
        assert got.shape == (M, N)
        assert tqm._grouped_applies(xt, packed, scale, zero, nbits, 128,
                                    superblock)
        _norm_close(got.numpy(), want)
        plain = tqm.qmm_plain(xt, packed, scale, zero, **kw).numpy()
        _norm_close(got.numpy(), plain, atol=1e-4)


def _owq_layouts():
    """(site, Kp, superblock) of OWQ's compacted Llama-2-7B linears at 3
    bits on average: each input width less its outlier columns, rounded
    up to whole groups, in the superblock ``owq_pack`` picks."""
    cfg = get_config("Llama-2-7b-hf")
    n_out = compute_n_out(cfg, 3.0, 128)
    inputs = {"self_attn.q_proj": cfg.hidden_size,
              "self_attn.o_proj": cfg.hidden_size,
              "mlp.gate_proj": cfg.hidden_size,
              "mlp.down_proj": cfg.intermediate_size}
    out = []
    for name, K in inputs.items():
        Kp = -(-(K - n_out[name]) // 128) * 128
        out.append((name, Kp, bitpack.pick_superblock(Kp, 128)))
    return out


def _ok(nbits, group, superblock, M=1, Kp=None, dtype=torch.bfloat16,
        cols=256, offset=0):
    Kp = Kp or 2 * superblock
    x = torch.zeros((M, Kp + 8), dtype=dtype)[:, offset:offset + Kp]
    packed = torch.zeros((Kp * nbits // 32, 256), dtype=torch.int32)[:, :cols]
    meta = torch.zeros((Kp // group, 256), dtype=torch.float32)
    return tqm._grouped_applies(x, packed, meta, meta, nbits, group,
                                superblock)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_grouped_routing_takes_every_small_superblock(nbits, monkeypatch):
    """``_grouped_applies`` (the one predicate that routes) takes every
    superblock ``pick_superblock`` gives OWQ's 7B sites -- down's Kp 11008
    in superblocks of 256 -- and a Kp of an odd number of groups (3968,
    superblock 128), at M 1-8; groups of 64 and 128 in superblocks of 128
    to 1024 rows; f32 x too (the ring's float32 form, the 4-row
    superblocks of 1 and 3 bits at 128 rows included).  It refuses M 9, groups of
    32, superblocks of 64 and 2048, misaligned operands; the pipelined
    GEMV and the one-launch MLP keep whole stages (superblocks of 1024
    taken, smaller refused)."""
    layouts = _owq_layouts() + [("odd", 31 * 128, bitpack.pick_superblock(
        31 * 128, 128))]
    assert ("mlp.down_proj", 11008, 256) in layouts
    assert layouts[-1][2] == 128
    for _, Kp, sb in layouts:
        for M in range(1, 9):
            assert _ok(nbits, 128, sb, M=M, Kp=Kp), (Kp, sb, M)
    for sb in (128, 256, 512, 1024):
        assert _ok(nbits, 64, sb) and _ok(nbits, 128, sb)
        assert tqm._grouped_whole_stages(nbits, sb) == (
            sb >= {1: 1024, 2: 512, 3: 512, 4: 256}[nbits])
    assert _ok(nbits, 128, 256, dtype=torch.float32)
    assert _ok(nbits, 128, 128, dtype=torch.float32)
    assert not _ok(nbits, 128, 256, M=9)
    assert not _ok(nbits, 32, 256)
    assert not _ok(nbits, 64, 64)
    assert not _ok(nbits, 128, 2048)
    assert not _ok(nbits, 128, 256, cols=252)          # Np
    assert not _ok(nbits, 128, 256, offset=4)          # x's alignment
    # the pipelined GEMV and the MLP: whole stages only
    monkeypatch.setattr(tqm, "_PIPE_DEFAULT", 1)
    x = torch.zeros((1, 2048), dtype=torch.bfloat16)

    def weights(sb, K=2048):
        return (torch.zeros((K * nbits // 32, 256), dtype=torch.int32),
                torch.zeros((K // 128, 256), dtype=torch.bfloat16),
                torch.zeros((K // 128, 256), dtype=torch.bfloat16))

    assert tqm._pipe_applies(x, *weights(1024), nbits, 128, 1024)
    assert tqm._mlp_applies(x, weights(1024), weights(1024), nbits, 128, 1024)
    for sb in (128, 256, 512):
        if tqm._grouped_whole_stages(nbits, sb):
            continue
        assert tqm._grouped_applies(x, *weights(sb), nbits, 64, sb)
        assert not tqm._pipe_applies(x, *weights(sb), nbits, 64, sb)
        assert not tqm._mlp_applies(x, weights(sb), weights(sb), nbits, 64,
                                    sb)


def _old_splits(N, nbits, sb, Kp, blocks, sms, rows=32, bn=256):
    """The stage plan before spanning stages (whole stages only)."""
    spb = (tqm._grouped_round_rows(nbits, sb)
           // tqm._grouped_stage_rows(nbits, rows))
    unit = spb if nbits == 8 else 1
    units = Kp // sb * spb // unit
    want = max(1, min(units, blocks * sms // -(-N // bn)))
    per = -(-units // want)
    return -(-units // per), per * unit


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
def test_grouped_stage_plan(nbits, monkeypatch):
    """The stage plan's arithmetic: whole-stage layouts split as before
    (Rg / n stages per superblock; 8 bits at whole superblocks);
    spanning layouts count one stage per n / Rg superblocks, the last one
    holding the rest, and every split ends at a stage; splits cover K
    with no empty split."""
    monkeypatch.setattr(tqm, "_sm_count", lambda index: 132)
    dev = torch.device("cpu")
    n = tqm._grouped_stage_rows(nbits)
    for sb in (128, 256, 512, 1024):
        if not tqm._grouped_layout(nbits, 128, sb):
            assert nbits == 8 or sb < 128
            continue
        rg = tqm._grouped_round_rows(nbits, sb)
        for n_sb in (1, 3, 43, 86):
            Kp = n_sb * sb
            stages = tqm._grouped_stages(nbits, sb, Kp)
            if rg >= n:
                assert rg % n == 0 and stages == n_sb * rg // n
            else:
                span = n // rg
                assert stages == -(-n_sb // span)
                tail = n_sb - (stages - 1) * span    # superblocks, last stage
                assert 1 <= tail <= span
            for N, blocks in ((4096, 1), (4096, 2), (320, 2), (32000, 2)):
                splits, per = tqm._grouped_splits(N, nbits, sb, Kp, blocks,
                                                  dev)
                assert (splits - 1) * per < stages <= splits * per
                if nbits == 8:
                    assert per % (rg // n) == 0      # whole superblocks
                if rg >= n:
                    assert (splits, per) == _old_splits(N, nbits, sb, Kp,
                                                        blocks, 132)
    # OWQ's down at 2 and 3 bits: 43 superblocks of 256, two a stage
    for b in (2, 3):
        assert tqm._grouped_stages(b, 256, 11008) == 22
        assert not tqm._grouped_whole_stages(b, 256)
