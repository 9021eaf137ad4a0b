"""The decode-GEMV probes of the port held to the JAX package's probe
scripts on the CPU.

The Pallas kernels of ``scripts/kernel_attrib.py`` (``_kernel``) and
``scripts/pipelined_gemv.py`` (``_pipe_kernel``) run in interpret mode,
built here with a 256-column block as ``check_parity`` builds them, at
N 256, K 2048 (two superblocks), widths 2, 3, 4.  The scripts are
imported by path; they ``setdefault`` a compilation-cache variable, so
they are imported with ``os.environ`` restored afterwards.  The port's
plain versions go against them at the scripts' 2e-2 normalized limit
(the limit ``tests/test_torch_ops.py`` holds the grouped form's plain
version to against the JAX kernels); the stripped variants' plain
versions against numpy formulas (the grouped ``ext_only`` against a numpy
replay of the grouped consumer's fragment extraction); ``Tracer``
against the JAX ``Tracer``.  The CUDA kernels themselves are held to
these plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import torch

from amq_tpu.core import quantize as jq
from amq_tpu.utils import profiling as jprof
from amq_tpu_torch.models.convert import to_tensor
from amq_tpu_torch.ops import quant_matmul as tqm
from amq_tpu_torch.probes import chain, kernel_attrib as ka
from amq_tpu_torch.probes import decode_ab as dab
from amq_tpu_torch.probes import grouped_ring as gr
from amq_tpu_torch.probes import kernel_roofline as kr
from amq_tpu_torch.probes import owq_ab
from amq_tpu_torch.probes import pipelined_gemv as pg
from amq_tpu_torch.utils import profiling as tprof

from test_torch_slice import torch_one_thread  # noqa: F401

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
N, K, SB, BN, GROUP = 256, 2048, 1024, 256, 128


@pytest.fixture
def script(monkeypatch):
    """Import one of the JAX package's probe scripts by path, leaving
    ``os.environ`` and ``sys.path`` as they were."""
    monkeypatch.setattr(os, "environ", os.environ.copy())
    monkeypatch.setattr(sys, "path", list(sys.path))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_probe_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


def _norm_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_layer(nbits, seed):
    """Random words [K*b/32, N] (uint32), bf16-exact scale in [0, 0.02) and
    zero in [0, 2^b - 1), x [1, K]."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (K * nbits // 32, N), dtype=np.uint64
                         ).astype(np.uint32)
    as_bf16 = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)
                                 .astype(jnp.float32))
    scale = as_bf16(rng.random((K // GROUP, N)) * 0.02)
    zero = as_bf16(rng.random((K // GROUP, N)) * (2**nbits - 1))
    x = as_bf16(rng.normal(size=(1, K)))
    return words, scale, zero, x


def _port(words, scale, zero, x):
    bf = torch.bfloat16
    return (to_tensor(words.view(np.int32)), torch.from_numpy(scale).to(bf),
            torch.from_numpy(zero).to(bf), torch.from_numpy(x).to(bf))


@pytest.mark.parametrize("body", ["gemv", "grouped"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_attrib_full_plain_matches_jax_kernel(script, nbits, body):
    """The port's full variant of each body (on the CPU, its plain version:
    the grouped form for ``grouped``, the per-weight form for ``gemv``)
    against scripts/kernel_attrib.py's ``_kernel(variant="full")`` (the
    production ``_gemv_blockdiag`` body), row 0, at the normalized 2e-2."""
    mod = script("kernel_attrib")
    words, scale, zero, x = _random_layer(nbits, 10 + nbits)
    rpt = SB * nbits // 32
    kern = functools.partial(mod._kernel, nbits=nbits, variant="full")
    x8 = jnp.zeros((8, K), jnp.bfloat16).at[0].set(
        jnp.asarray(x[0]).astype(jnp.bfloat16))
    meta = lambda a: jnp.asarray(a).astype(jnp.bfloat16).reshape(
        K // SB, SB // GROUP, N)
    meta_spec = pl.BlockSpec((1, SB // GROUP, BN), lambda n, k: (k, 0, n))
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, grid=(N // BN, K // SB),
            in_specs=[pl.BlockSpec((8, SB), lambda n, k: (0, k)),
                      pl.BlockSpec((rpt, BN), lambda n, k: (k, n)),
                      meta_spec, meta_spec],
            out_specs=pl.BlockSpec((8, BN), lambda n, k: (0, n)),
            out_shape=jax.ShapeDtypeStruct((8, N), jnp.bfloat16),
        )(x8, jnp.asarray(words), meta(scale), meta(zero))
    pk, sc, zr, xt = _port(words, scale, zero, x)
    got = ka.gemv_attrib(xt, pk, sc, zr, nbits=nbits, group_size=GROUP,
                         shape=(N, K), superblock=SB, variant="full",
                         body=body)
    assert got.y.shape == (1, N) and got.xr is None and got.cs is None
    assert _norm_err(got.y.float().numpy(), np.asarray(want[:1], np.float32)
                     ) < 2e-2


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_extract_ahead_plain_matches_jax_kernel(script, nbits):
    """The port's extract-ahead GEMV (on the CPU, its plain version)
    against scripts/pipelined_gemv.py's ``_pipe_kernel`` on quantized
    weights, row 0, and both against the dequantize-then-matmul
    reference."""
    mod = script("pipelined_gemv")
    rng = np.random.default_rng(20 + nbits)
    qt = jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                 * 0.02), nbits=nbits, group_size=GROUP)
    assert qt.superblock == SB
    x = jnp.asarray(rng.normal(size=(8, K)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    rpt = SB * nbits // 32
    kern = functools.partial(mod._pipe_kernel, nbits=nbits, Kt=K // SB)
    s_b, z_b = qt.scale.astype(jnp.bfloat16), qt.zero.astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, grid=(N // BN,),
            in_specs=[pl.BlockSpec((8, K), lambda n: (0, 0)),
                      pl.BlockSpec((K // GROUP, BN), lambda n: (0, n)),
                      pl.BlockSpec((K // GROUP, BN), lambda n: (0, n)),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((8, BN), lambda n: (0, n)),
            out_shape=jax.ShapeDtypeStruct((8, N), jnp.bfloat16),
            scratch_shapes=[pltpu.VMEM((2, rpt, BN), jnp.uint32),
                            pltpu.VMEM((2, SB, BN), jnp.bfloat16),
                            pltpu.SemaphoreType.DMA((2,))],
        )(x, s_b, z_b, qt.packed)
    got = pg.gemv_extract_ahead(
        to_tensor(np.asarray(x[:1])), to_tensor(np.asarray(qt.packed)),
        to_tensor(np.asarray(s_b)), to_tensor(np.asarray(z_b)), nbits=nbits,
        group_size=GROUP, shape=(N, K), superblock=SB)
    assert got.shape == (1, N) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _norm_err(got, np.asarray(want[:1], np.float32)) < 2e-2
    ref = np.asarray(x[:1], np.float32) @ np.asarray(
        jq.dequantize(jq.QuantizedTensor(qt.packed, s_b.astype(jnp.float32),
                                         z_b.astype(jnp.float32), nbits,
                                         GROUP, (N, K), SB))).T
    assert _norm_err(got, ref) < 2e-2


def _np_fields_sum(words, nbits):
    """Sum per column of every field of every word (numpy): per superblock
    the 3-bit layout is 64 rows of 2-bit fields, then 32 of 1-bit."""
    w = words.astype(np.uint64)
    planes = ([(0, SB * nbits // 32, nbits)] if nbits != 3
              else [(0, SB // 16, 2), (SB // 16, SB * 3 // 32, 1)])
    total = np.zeros(N, np.int64)
    rows = SB * nbits // 32
    for s in range(K // SB):
        blk = w[s * rows:(s + 1) * rows]
        for lo, hi, b in planes:
            for shift in range(0, 32, b):     # every b-bit field is a code
                total += ((blk[lo:hi] >> shift) & (2**b - 1)).sum(0).astype(
                    np.int64)
    return total


@pytest.mark.parametrize("variant", ["fma_only", "ext_only", "load_only"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_stripped_variants_plain_match_numpy(nbits, variant):
    words, scale, zero, x = _random_layer(nbits, 30 + nbits)
    pk, sc, zr, xt = _port(words, scale, zero, x)
    got = ka.gemv_attrib(xt, pk, sc, zr, nbits=nbits, group_size=GROUP,
                         shape=(N, K), superblock=SB, variant=variant,
                         body="gemv")
    words_xor = np.bitwise_xor.reduce(words, axis=0).view(np.int32)
    meta_xor = np.bitwise_xor.reduce(
        scale.view(np.uint32) ^ zero.view(np.uint32), axis=0).view(np.int32)
    if variant == "fma_only":
        C = 387.0 if nbits == 3 else 129.0
        w = np.repeat((C - zero.astype(np.float64)) * scale, GROUP, axis=0)
        assert _norm_err(got.y.float().numpy(), x.astype(np.float64) @ w
                         ) < 1e-2
        np.testing.assert_array_equal(got.xr.numpy(), words_xor)
        assert got.cs is None
    elif variant == "ext_only":
        assert got.y is None
        np.testing.assert_array_equal(got.xr.numpy(), meta_xor)
        np.testing.assert_array_equal(got.cs.numpy(),
                                      _np_fields_sum(words, nbits))
    else:
        assert got.y is None and got.cs is None
        np.testing.assert_array_equal(got.xr.numpy(), words_xor ^ meta_xor)


def _np_fragment_fold(words, nbits):
    """The grouped consumer's A fragments replayed word by word in numpy
    (qmm_tile.cuh's low_frag / low_shift): per superblock and extraction
    round p, each word row shifted in place -- 1/2/4-bit by b * per_shift
    every per_shift rounds, the round's field read at offset o under the
    pair mask << o; 3-bit the 2-bit row of p's parity shifted by 2 every
    odd round, the 1-bit row by 1 every round, read as 2 hi + lo -- OR
    0x4300_4300, XOR-folded per column."""
    w = words.astype(np.uint32)
    rows = SB * nbits // 32
    fold = np.zeros(N, np.uint32)
    for s in range(K // SB):
        blk = w[s * rows:(s + 1) * rows]
        if nbits == 3:
            hi, lo = blk[:64], blk[64:]             # 2-bit rows r, 32 + r
            for p in range(16):
                sel = (hi[32:] if p & 1 else hi[:32]) >> (2 * (p // 2))
                a = (((sel << 1) & 0x00060006) | ((lo >> p) & 0x00010001)
                     | 0x43004300)
                fold ^= np.bitwise_xor.reduce(a.astype(np.uint32), axis=0)
        else:
            per_shift = (7 - nbits) // nbits + 1 if nbits < 4 else 1
            mask = ((1 << nbits) - 1) * 0x00010001
            for p in range(16 // nbits):
                o = p % per_shift * nbits
                shifted = blk >> (nbits * per_shift * (p // per_shift))
                a = (shifted & (mask << o)) | 0x43004300
                fold ^= np.bitwise_xor.reduce(a.astype(np.uint32), axis=0)
    return fold.view(np.int32)


@pytest.mark.parametrize("variant", ["mma_only", "ext_only", "load_only"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_grouped_stripped_variants_plain_match_numpy(nbits, variant):
    """The grouped body's stripped variants (on the CPU, their plain
    versions) against numpy: mma_only's y is the grouped form with every
    code 1, sum_g s (129 - (z + 128)) xsum_g over the bf16 x's group sums
    (normalized 1e-2, the kernel-vs-plain limit FMA_TOL), its xr the
    words' XOR; ext_only's xr the fragments' XOR; load_only's the words'
    and the meta's."""
    words, scale, zero, x = _random_layer(nbits, 40 + nbits)
    pk, sc, zr, xt = _port(words, scale, zero, x)
    got = ka.gemv_attrib(xt, pk, sc, zr, nbits=nbits, group_size=GROUP,
                         shape=(N, K), superblock=SB, variant=variant,
                         body="grouped")
    words_xor = np.bitwise_xor.reduce(words, axis=0).view(np.int32)
    meta_xor = np.bitwise_xor.reduce(
        scale.view(np.uint32) ^ zero.view(np.uint32), axis=0).view(np.int32)
    assert got.cs is None
    if variant == "mma_only":
        xsum = x.astype(np.float64).reshape(K // GROUP, GROUP).sum(1)
        want = (xsum[:, None] * scale * (1.0 - zero)).sum(0)[None]
        assert _norm_err(got.y.float().numpy(), want) < ka.FMA_TOL
        np.testing.assert_array_equal(got.xr.numpy(), words_xor)
    elif variant == "ext_only":
        assert got.y is None
        np.testing.assert_array_equal(got.xr.numpy(),
                                      _np_fragment_fold(words, nbits))
    else:
        assert got.y is None
        np.testing.assert_array_equal(got.xr.numpy(), words_xor ^ meta_xor)


def test_tracer_matches_jax_tracer(tmp_path):
    spans = ["eval", "probe", "eval", "eval", "probe", "search"]
    tracers = (jprof.Tracer(), tprof.Tracer())
    for t in tracers:
        for name in spans:
            with t.span(name):
                pass
        with pytest.raises(ValueError):
            with t.span("raised"):
                raise ValueError
    j, p = (t.summary() for t in tracers)
    assert list(j) == list(p) == sorted(set(spans) | {"raised"})
    for k in j:
        assert j[k].keys() == p[k].keys()
        assert j[k]["count"] == p[k]["count"]
    tracers[1].dump(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()).keys() == p.keys()


def test_device_trace_writes_a_chrome_trace_and_raises(tmp_path, monkeypatch):
    with tprof.device_trace(None) as prof:
        assert prof is None
    with tprof.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64) @ torch.ones(64)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]

    def refuse(*a, **k):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(tprof, "profile", refuse)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with tprof.device_trace(str(tmp_path / "again")):
            pass


@pytest.fixture
def small_sites(monkeypatch):
    """The probes' sites and roofline shapes cut to the tests' size."""
    monkeypatch.setattr(chain, "SITES", {"o": (N, K), "down": (N, K - 128)})
    monkeypatch.setattr(kr, "SHAPES", (("o_proj", N, 256),
                                       ("down", N, 640)))


def test_probe_entry_points_on_the_cpu(capsys, small_sites):
    recs = ka.main(["o", "2", "3", "4"], device="cpu")
    recs += ka.main(["down", "4"], device="cpu")      # the SwiGLU prologue
    assert [(r["nbits"], r["body"]) for r in recs] == [
        (b, body) for b in (2, 3, 4, 4) for body in ("gemv", "grouped")]
    assert all(list(r["checks"]) == list(ka.VARIANTS[r["body"]])
               for r in recs)
    assert all(r["ok"] and r["us"] is None for r in recs)
    assert all(r["checks"]["full"]["equal_production"] for r in recs)
    pipe = pg.main(["o", "2", "3", "4"], device="cpu")
    assert all(r["ok"] and "extract_ahead_us" not in r for r in pipe)
    roof = kr.main([], device="cpu")
    assert [(r["nbits"], r["container"]) for r in roof] == list(kr.PAIRS) * 2
    assert all(r["ok"] and "us" not in r for r in roof)
    out = capsys.readouterr().out
    assert out.count("ATTRIB ") == 8 and out.count("PIPE_PROBE ") == 3
    assert out.count("ROOFLINE ") == 10
    assert chain.CHAIN_LAUNCHES == 2 * (8 + 40)
    with pytest.raises(SystemExit):
        ka.main(["gu", "4"], device="cpu")
    with pytest.raises(SystemExit):
        pg.main(["lm_head", "4"], device="cpu")


def test_probe_entry_points_refuse_without_a_card(monkeypatch, small_sites):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CUDA default is valid here")
    for main, argv in ((ka.main, ["o", "2"]), (pg.main, ["o", "2"]),
                       (kr.main, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)

    def tripwire(*a, **k):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(ka, "attrib_plain", tripwire)
    monkeypatch.setattr(pg, "extract_ahead_plain", tripwire)
    x = torch.empty((1, K), dtype=torch.bfloat16, device="meta")
    packed = torch.empty((K * 4 // 32, N), dtype=torch.int32, device="meta")
    meta = torch.empty((K // GROUP, N), dtype=torch.bfloat16, device="meta")
    kw = dict(nbits=4, group_size=GROUP, shape=(N, K), superblock=SB)
    with pytest.raises(ValueError, match="no kernel for device"):
        ka.gemv_attrib(x, packed, meta, meta, **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        pg.gemv_extract_ahead(x, packed, meta, meta, **kw)


def test_grouped_ring_sweep_starts_at_the_shipped_shape():
    """The ring-shape sweep's first variant is qmm_tile.cuh's default ring,
    whose column tile and stage rows are the wrapper's (the card test
    ``test_cuda_grouped_ring_holds_two_blocks_per_sm`` holds its
    occupancy); every variant's stage is whole 8-row MMA steps; the probe
    refuses the CPU and widths it has no site for."""
    src = (Path(__file__).resolve().parent.parent / "amq_tpu_torch" / "csrc"
           / "qmm_tile.cuh").read_text()
    default = tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                    for name in ("AMQ_GTILES", "AMQ_GSR", "AMQ_GSTAGES"))
    assert gr.VARIANTS[0] == default
    assert 128 * default[0] == tqm._GROUPED_BN
    assert default[1] == tqm._GROUPED_ROWS
    assert all(rows % 8 == 0 and 64 % rows == 0 for _, rows, _ in gr.VARIANTS)
    assert len(set(gr.VARIANTS)) == len(gr.VARIANTS)
    with pytest.raises(SystemExit):
        gr.main(device="cpu")
    with pytest.raises(SystemExit):
        gr.main(["5"], device="cpu")


def test_owq_ab_refuses_no_roots_and_a_root_without_the_package(tmp_path):
    """The OWQ A/B takes at least one checkout, and a root without the
    package (the child would import another tree's) fails its child
    rather than measuring the wrong package."""
    import subprocess
    with pytest.raises(SystemExit, match="usage"):
        owq_ab.main([])
    with pytest.raises(subprocess.CalledProcessError):
        owq_ab.run(str(tmp_path), "owq")


def test_decode_ab_refuses_no_roots_and_a_failed_root(tmp_path):
    """The decode A/B takes at least one checkout, and a checkout whose run
    fails (here: no ``chip_smoke.py`` to import) stops it with the
    child's error rather than a record."""
    with pytest.raises(SystemExit, match="usage"):
        dab.main([])
    with pytest.raises(SystemExit, match="chip_smoke"):
        dab.run(str(tmp_path), steps=1, repeats=1)


def test_decode_ab_takes_a_compute_dtype(tmp_path):
    """``--dtype float32`` runs the A/B with the engine in float32 (the
    child gets the dtype; a root without ``chip_smoke.py`` still stops it
    with the child's error); any other dtype, or the flag without roots,
    is refused."""
    for argv in (["--dtype", "float16", str(tmp_path)], ["--dtype"],
                 ["--dtype", "float32"]):
        with pytest.raises(SystemExit, match="usage"):
            dab.main(argv)
    with pytest.raises(SystemExit, match="chip_smoke"):
        dab.main(["--dtype", "float32", str(tmp_path)])


def test_count_sass_reads_each_attribution_kernel():
    """The SASS counter on a listing in cuobjdump's layout: per kernel its
    body, width, variant (by the body's own names) and instruction counts
    (predicated ones too)."""
    def fn(body, nb, v, lines):
        kind = "pinned" if v and body == "gemv" else "kernel"
        name = (f"_ZN47_GLOBAL__N__x_{body}_attrib_{body}_{kind}ILi{nb}E"
                f"Li{v}EEEvN3amq8GemvArgsENS_5ProbeE")
        code = "".join(f"        /*{i * 16:04x}*/   {op} R1, R2 ;  /* 0x0 */\n"
                       f"                          /* 0x0 */\n"
                       for i, op in enumerate(lines))
        return f"\t\tFunction : {name}\n\t.headerflags ...\n{code}"
    listing = ("Fatbin elf code:\n"
               + fn("grouped", 4, 1, ["HMMA.16816.F32.BF16", "LDS.64",
                                      "@P0 HMMA.16816.F32.BF16", "LOP3.LUT",
                                      "BRA"])
               + fn("gemv", 2, 0, ["I2FP.F32.U32", "I2F.U32", "@!P1 FFMA",
                                   "LDG.E.CONSTANT", "SHF.R.U32.HI", "LDS"]))
    zero = dict(FFMA=0, I2F=0, LDG=0, LDS=0, HMMA=0, LOP3=0, SHF=0)
    assert ka.count_sass(listing) == [
        dict(zero, body="gemv", nbits=2, variant="full", FFMA=1, I2F=2,
             LDG=1, LDS=1, SHF=1),
        dict(zero, body="grouped", nbits=4, variant="mma_only", LDS=1,
             HMMA=2, LOP3=1)]


def test_count_ops_reads_each_matching_kernel():
    """The generic SASS counter on a canned listing with the bf16 flash
    kernel, the f32 one and a decode-attention kernel: only the symbols
    matching the pattern, each with its own instructions."""
    def fn(name, ops):
        code = "".join(f"        /*{i * 16:04x}*/   {op} R1, R2 ;  /* 0x0 */\n"
                       f"                          /* 0x0 */\n"
                       for i, op in enumerate(ops))
        return f"\t\tFunction : {name}\n\t.headerflags ...\n{code}"
    wgmma = "_ZN52_GLOBAL__N__f_12345_18flash_kernel_wgmmaILi128EEEvPK13__nv_bfloat16"
    f32 = "_ZN52_GLOBAL__N__f_12345_12flash_kernelIfLi64EEEvPKT_S3_"
    dec = ("_ZN52_GLOBAL__N__d_12345_18decode_attn_kernelI13__nv_bfloat16S1_"
           "fLi128ELi1EEEvPKT_")
    listing = ("Fatbin elf code:\n"
               + fn(wgmma, ["HGMMA.64x64x16.F32.BF16", "@P0 HGMMA.64x128x16.F32.BF16",
                            "FFMA", "BAR.SYNC"])
               + fn(f32, ["FFMA", "FFMA", "@!P2 FFMA", "LDS.128"])
               + fn(dec, ["LDG.E.128.CONSTANT", "FFMA", "SHFL.BFLY"]))
    ops = ("HGMMA", "HMMA", "FFMA")
    assert ka.count_ops(listing, "flash_kernel", ops) == {
        wgmma: dict(HGMMA=2, HMMA=0, FFMA=1),
        f32: dict(HGMMA=0, HMMA=0, FFMA=3)}
    assert ka.count_ops(listing, "decode_attn", ("LDG", "SHFL")) == {
        dec: dict(LDG=1, SHFL=1)}
    # the attribution counter ignores kernels that are not its own
    assert ka.count_sass(listing) == []


def test_ptxas_usage_reads_each_kernel():
    """Registers, stack frame and spill bytes per kernel from nvcc's
    ``-Xptxas -v`` report."""
    from amq_tpu_torch.ops import _cuda
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bPf\n"
        "    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 384 bytes cmem[0]\n")
    assert _cuda.ptxas_usage(log) == {
        "_Z1aPf": dict(registers=168, stack=0, spill_stores=0, spill_loads=0),
        "_Z1bPf": dict(registers=255, stack=24, spill_stores=20,
                       spill_loads=16)}


def test_kernel_names_shorten_symbols(monkeypatch):
    """Mangled kernel symbols as short names through c++filt; a symbol
    stays as it is where no demangler is installed."""
    import shutil
    syms = ["_ZN51_GLOBAL__N__00f851f7_18_flash_attention_cu_ddd85e8f18"
            "flash_kernel_wgmmaILi128EEEvPK13__nv_bfloat16S3_S3_PKiPS1_iiiiif",
            "_ZN52_GLOBAL__N__28b647d7_19_decode_attention_cu_5aaacd3a18"
            "decode_attn_kernelI13__nv_bfloat16S1_fLi128ELi1EEEvPKT_PKT0_S7_"
            "S4_S4_PKiPT1_iiiif",
            "_ZN43_GLOBAL__N__aecdb13f_10_dequant_cu_8759f20414dequant_kernel"
            "ILi8ELi1EEEvNS_6DqArgsE"]
    if shutil.which("c++filt") or shutil.which("cu++filt"):
        assert list(ka.kernel_names(syms).values()) == [
            "flash_kernel_wgmma<128>", "decode_attn_kernel<bf16, bf16, float, 128, 1>",
            "dequant_kernel<8, 1>"]
    monkeypatch.setattr(ka.shutil, "which", lambda name: None)
    assert ka.kernel_names(syms) == {s: s for s in syms}
