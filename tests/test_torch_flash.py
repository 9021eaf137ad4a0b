"""The port's flash attention held to the JAX package's on the CPU.

``flash_attention_plain`` (what a CPU tensor gets, and what the CUDA
kernel is held to on the card) against the JAX Pallas kernel run in
interpret mode, on the JAX suite's five cases plus bf16 (at d 64, with
GQA at S 192, with an offset and T unaligned to 64), d 64 and non-causal
ones; and the model's attention routing around the kernel.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amq_tpu.ops.flash_attention import flash_attention as j_flash

import torch

from amq_tpu_torch.models import llama as tllama
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.ops import flash_attention as tfa

from test_torch_slice import torch_one_thread  # noqa: F401

# (B, Hq, Hkv, S, T, d, offset, dtype, JAX kernel kwargs)
CASES = {
    "aligned": (1, 4, 2, 128, 128, 128, 0, "float32", {}),
    "unaligned_t_small": (1, 4, 2, 128, 136, 128, 0, "float32", {}),
    "unaligned_t_multi_tile": (1, 4, 2, 128, 320, 128, 0, "float32",
                               {"block_k": 256}),
    "unaligned_t_with_offset": (1, 4, 2, 128, 200, 128, 64, "float32", {}),
    "gqa_multi_batch": (2, 8, 2, 256, 264, 128, 8, "float32",
                        {"block_q": 128, "block_k": 128}),
    "bf16": (1, 4, 4, 128, 192, 128, 32, "bfloat16", {}),
    "d64": (2, 4, 2, 128, 128, 64, 0, "float32", {}),
    # shapes the tensor-core kernel's 128-row, 64-key tiling meets in bf16
    "bf16_d64": (2, 4, 2, 128, 128, 64, 0, "bfloat16", {}),
    "bf16_gqa_s192": (1, 8, 2, 192, 192, 128, 0, "bfloat16", {}),
    "bf16_offset_unaligned_t": (1, 4, 2, 128, 200, 128, 40, "bfloat16", {}),
}


def _inputs(B, Hq, Hkv, S, T, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, d)).astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(name):
    B, Hq, Hkv, S, T, d, offset, dtype, kw = CASES[name]
    q, k, v = _inputs(B, Hq, Hkv, S, T, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                       jnp.int32(offset), **kw)
    want = np.asarray(want.astype(jnp.float32))
    got = tfa.flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                              torch.tensor(offset, dtype=torch.int32))
    assert got.dtype == td and tuple(got.shape) == (B, Hq, S, d)
    got = got.float().numpy()
    if dtype == "float32":
        # the JAX suite's tolerance; sums run in other orders
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        # one bf16 rounding of p and of the output each (2^-8 relative);
        # the kernel rounds p against a running max, the plain version
        # against the final one
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-2)


def test_plain_non_causal_is_softmax_attention():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 96, 64, 1))
    got = tfa.flash_attention(q, k, v, causal=False)
    want = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1) @ v
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_offset_forms_agree():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 64, 128, 64, 2))
    a = tfa.flash_attention(q, k, v, 32)
    b = tfa.flash_attention(q, k, v, torch.tensor([32], dtype=torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scalar"):
        tfa._offset_tensor(torch.zeros(2, dtype=torch.int32), "cpu")


def test_flash_routing_rule():
    cfg = t_get_config("tiny-llama")
    assert not tllama._flash_ok(128, 128, cfg, "cpu")      # CPU: einsum path
    assert tllama._flash_ok(128, 128, cfg, "cuda")
    assert not tllama._flash_ok(64, 64, cfg, "cuda")       # S < 128
    assert not tllama._flash_ok(192 + 32, 256, cfg, "cuda")  # S % 64
    windowed = dataclasses.replace(cfg, sliding_window=100)
    assert not tllama._flash_ok(128, 128, windowed, "cuda")
    with tllama.forward_kernels(False):
        assert not tllama._flash_ok(128, 128, cfg, "cuda")
    assert tllama._flash_ok(128, 128, cfg, "cuda")


@pytest.mark.parametrize("offset", [0, 40])
def test_model_attention_paths_agree(offset):
    """The model's einsum attention (CPU), the plain flash version and the
    JAX kernel give one answer on the model's layouts, with the appended
    keys written at ``offset`` as ``attention_append`` does."""
    cfg = t_get_config("tiny-llama")
    B, S, Hq, Hkv, hd, T = 2, 128, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, 192
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(B, S, Hq, hd)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(B, Hkv, T, hd)).astype(np.float32))
              for _ in range(2))
    kn, vn = (torch.from_numpy(rng.normal(size=(B, Hkv, S, hd)).astype(np.float32))
              for _ in range(2))
    off = torch.tensor(offset, dtype=torch.int32)
    split = tllama.attention_append(q, kc, vc, kn, vn, off, S, T, cfg,
                                    torch.float32)
    pos = off + torch.arange(S)
    kb, vb = kc.index_copy(2, pos, kn), vc.index_copy(2, pos, vn)
    plain = tfa.flash_attention(q.transpose(1, 2).contiguous(), kb, vb,
                                off).transpose(1, 2)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash(jnp.asarray(q.transpose(1, 2).numpy()),
                       jnp.asarray(kb.numpy()), jnp.asarray(vb.numpy()),
                       jnp.int32(offset))
    want = np.asarray(want).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(split.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-4, atol=2e-4)
