"""Split TF32 (3xTF32), the float32 flash kernel's arithmetic, emulated on
the CPU and held to the JAX package and to the plain version.

The CUDA kernel (``csrc/flash_attention.cu``, ``flash_kernel_tf32x3``)
takes both products of float32 attention, S = (q * scale) K^T and O = P V,
on the tensor cores in TF32: every operand x is split as hi = tf32(x),
lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, on the 13 low mantissa bits), and each product is taken as
lo * hi + hi * lo + hi * hi in f32.  A product of two TF32 values is exact
in f32, so f32 products of the split parts emulate the tensor cores' (the
order of the sums aside).  The emulation is held to the JAX kernel in
interpret mode within the JAX suite's 2e-4 and to ``flash_attention_plain``
within 1e-5; the pinned case records why both products are split: one
TF32 product on either side misses 2e-4.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from amq_tpu.ops.flash_attention import flash_attention as j_flash

import torch

import chip_smoke
from amq_tpu_torch.ops import flash_attention as tfa
from amq_tpu_torch.probes import kernel_attrib as ka

from test_torch_flash import CASES, _inputs
from test_torch_slice import torch_one_thread  # noqa: F401

#: the float32 cases of tests/test_torch_flash.py (causal, GQA, offsets, T
#: unaligned to 64, d 64) and a non-causal one (the JAX kernel takes it at
#: T a multiple of its key block): (B, Hq, Hkv, S, T, d, offset, causal,
#: JAX kernel kwargs)
F32_CASES = {
    **{name: (*c[:7], True, c[8]) for name, c in CASES.items()
       if c[7] == "float32"},
    "non_causal": (1, 4, 4, 128, 192, 128, 0, False, {}),
}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it
    (finite values): half of the dropped 13 bits' unit added to the
    magnitude, then those bits cleared, through an int32 view (sign and
    magnitude, so the carry rounds away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo): x = hi + lo up to 2^-22 |x|, both TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in f32 sums: "f32", "tf32" (one product of the rounded
    operands) or "split" (the small terms, then hi * hi)."""
    if mode == "f32":
        return a @ b
    if mode == "tf32":
        return tf32_round(a) @ tf32_round(b)
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def attention(q, k, v, offset=0, causal=True, qk="split", pv="split"):
    """``flash_attention_plain``'s function with its two products taken in
    ``qk`` and ``pv`` arithmetic (:func:`product`); f32 tensors."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qs = (q * (1.0 / math.sqrt(d))).reshape(B, Hkv, G * S, d)
    s = product(qs, k.transpose(-1, -2), qk).reshape(B, Hkv, G, S, T)
    if causal:
        keep = torch.arange(T)[None, :] <= offset + torch.arange(S)[:, None]
        s = torch.where(keep, s, torch.full((), tfa.NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = product(p.reshape(B, Hkv, G * S, T), v, pv).reshape(B, Hkv, G, S, d)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, Hq, S, d)


@pytest.mark.parametrize("x, want", [
    (1 + 2 ** -11, 1 + 2 ** -10),                 # a tie rounds away
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),              # a tie, odd below
    (1 + 2 ** -11 - 2 ** -23, 1.0),               # below the tie
    (2 - 2 ** -23, 2.0),                          # carry into the exponent
    (3.0, 3.0),
    (2 ** -130, 2 ** -130),                       # subnormal, 10 bits
])
def test_tf32_round_to_nearest_away(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == np.float32(want)


def test_split_parts_are_tf32_and_sum_to_x():
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=4096).astype(np.float32)) * 10.0 ** torch.arange(-4, 4).repeat(512)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(x - hi, (x.double() - hi.double()).float())  # exact
    assert ((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("name", list(F32_CASES))
def test_split_emulation_matches_jax_kernel(name):
    B, Hq, Hkv, S, T, d, offset, causal, kw = F32_CASES[name]
    q, k, v = _inputs(B, Hq, Hkv, S, T, d)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                       jnp.int32(offset), causal=causal, **kw)
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), offset, causal)
    # the JAX suite's tolerance; sums run in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", list(F32_CASES))
def test_split_emulation_within_1e5_of_plain(name):
    B, Hq, Hkv, S, T, d, offset, causal, _ = F32_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, Hq, Hkv, S, T, d))
    want = tfa.flash_attention_plain(q, k, v, torch.tensor(offset), causal)
    got = attention(q, k, v, offset, causal)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.fixture(scope="module")
def pinned():
    """One causal head at the evaluation shape, S = T = 2048, d 128, from a
    numpy seed, and its plain (float32) attention."""
    rng = np.random.default_rng(2048)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1, 2048, 128))
                                .astype(np.float32)) for _ in range(3))
    return q, k, v, tfa.flash_attention_plain(q, k, v)


@pytest.mark.parametrize("qk, pv, within", [
    ("split", "split", True),
    ("tf32", "split", False),
    ("split", "tf32", False),
    ("tf32", "tf32", False),
])
def test_one_tf32_product_misses_the_tolerance(pinned, qk, pv, within):
    """Both products split: under 1e-5 of the plain version; one TF32
    product on either side: over the JAX suite's 2e-4 (why the kernel
    splits both)."""
    q, k, v, want = pinned
    err = (attention(q, k, v, qk=qk, pv=pv) - want).abs().max().item()
    if within:
        assert err <= 1e-5, err
    else:
        assert err > 2e-4, err


def test_sass_gate_counts_tf32_products_of_the_f32_kernel():
    """chip_smoke.py's gate on the f32 flash kernel: on a listing in
    cuobjdump's layout, the TF32 tensor-core products of the kernels named
    like it, not the bf16 kernel's products nor a kernel without any."""
    def fn(name, ops):
        code = "".join(f"        /*{i * 16:04x}*/   {op} R1, R2 ;  /* 0x0 */\n"
                       f"                          /* 0x0 */\n"
                       for i, op in enumerate(ops))
        return f"\t\tFunction : {name}\n\t.headerflags ...\n{code}"
    tf32 = "_ZN52_GLOBAL__N__f_12345_19flash_kernel_tf32x3ILi128EEEvPKfS2_"
    tf32_64 = "_ZN52_GLOBAL__N__f_12345_19flash_kernel_tf32x3ILi64EEEvPKfS2_"
    wgmma = "_ZN52_GLOBAL__N__f_12345_18flash_kernel_wgmmaILi128EEEvPK13__nv_bfloat16"
    listing = ("Fatbin elf code:\n"
               + fn(tf32, ["HMMA.1688.F32.TF32", "@P0 HMMA.1688.F32.TF32",
                           "FFMA", "LDS.128"])
               + fn(tf32_64, ["FFMA", "HMMA.16816.F32.BF16"])
               + fn(wgmma, ["HGMMA.64x64x16.F32.BF16", "HMMA.1688.F32.TF32"]))
    forms = {"TF32_MMA": chip_smoke.TF32_MMA}
    assert ka.count_forms(listing, chip_smoke.TF32_FLASH, forms) == {
        tf32: {"TF32_MMA": 2}, tf32_64: {"TF32_MMA": 0}}
