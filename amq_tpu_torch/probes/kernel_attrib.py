"""Attribution of the decode GEMVs: their bodies with parts removed.

    python -m amq_tpu_torch.probes.kernel_attrib [o|qkv|gu|down] [nbits...]

The counterpart of the JAX package's ``scripts/kernel_attrib.py``.  For
each width (2, 3 with the native 2+1 planes, 4; bf16 meta, M = 1) and
each body -- the grouped GEMV every bf16 decode GEMV at M <= 8 runs
(``grouped``: ``csrc/qmm_grouped.cuh``'s ring, producer warp, mbarriers,
splits and launch bounds; the JAX script's ``_gemv_blockdiag`` body) and
the CUDA-core GEMV that f32 activations and the layouts the ring refuses
take (``gemv``: ``csrc/quant_matmul.cu``'s ``qmm_gemv_kernel``) -- it runs
``csrc/gemv_attrib.cu`` in four variants, chain-timed
(``probes/chain.py``).  Grouped body (the script's full / dot_only /
ext_only / dma_only):

  full       the grouped consumer itself; bit-identical to the grouped
             GEMV (``quant_matmul_indexed`` at M = 1, bf16)
  mma_only   the same MMAs and corrections on constant codes (code 1 in
             every field), the words XOR-folded
  ext_only   the extraction into MMA fragments, each fragment XOR-folded
             per column in place of the MMAs
  load_only  wait on the stage, XOR-fold its words and each group's meta

GEMV body: ``full`` (bit-identical to the CUDA-core GEMV,
``ops.quant_matmul._qmm_cuda_core``), ``fma_only`` (no extraction, every
code 129, full's FMA count), ``ext_only`` (full's extraction, codes
summed, no FMA against x), ``load_only`` (words and meta XOR-folded).

Every variant loads the same bytes, with as many blocks resident per SM
as ``full`` (:func:`occupancy`; ``pinned`` in the record).
``full - max(others)`` is the overlap slack; the variant whose time
tracks ``full`` is on the critical path (``tracks_full``, None where a
variant is not pinned).
The down site takes the SwiGLU prologue, as production runs it.

The stripped variants do not copy the TPU script's stripped outputs (its
``dma_only`` sums random words bitcast to bf16, which is not finite):
each is a deterministic function whose plain version is here, and the
card holds each variant to it -- exactly for the XOR folds and the code
sums, at the GEMV's bf16 tolerance for ``fma_only`` / ``mma_only``.
``main`` checks each body's ``full`` against the route whose bits it
carries with ``torch.equal`` first.  On the CPU (``device="cpu"``) the
wrapper takes the plain versions and nothing is timed.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.bitpack import unpack, wrap_int32
from ..core.device import resolve_device
from ..ops import _cuda
from ..ops import quant_matmul as qm
from . import chain

BODIES = ("gemv", "grouped")
#: each body's variants, in the kernel's order
VARIANTS = {"gemv": ("full", "fma_only", "ext_only", "load_only"),
            "grouped": ("full", "mma_only", "ext_only", "load_only")}
#: max |kernel - plain| / max |plain| of the full, fma_only and mma_only
#: bf16 outputs against their plain versions (one rounding on either side,
#: f32 sums in another order)
FMA_TOL = 1e-2
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


class AttribOut(NamedTuple):
    """One variant's outputs: ``y`` [1, N] (full, fma_only, mma_only),
    ``xr`` [N] int32 XOR fold (fma_only, mma_only: words; GEMV body's
    ext_only: meta; grouped ext_only: the MMA fragments; load_only: words
    and meta), ``cs`` [N] f32 code sums (GEMV body's ext_only); None where
    the variant has none."""
    y: Optional[torch.Tensor]
    xr: Optional[torch.Tensor]
    cs: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# plain versions

def xor_fold(t: torch.Tensor) -> torch.Tensor:
    """XOR of an int32 ``[R, N]`` over its rows -> ``[N]``."""
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])])
        t = t[0::2] ^ t[1::2]
    return t[0]


def meta_fold(scale, zero, N) -> torch.Tensor:
    """XOR over groups of the float32 bits of scale and of zero."""
    bits = (scale[:, :N].float().contiguous().view(torch.int32)
            ^ zero[:, :N].float().contiguous().view(torch.int32))
    return xor_fold(bits)


def code_sums(packed, nbits, superblock, N) -> torch.Tensor:
    """Sum per column of every extracted field (3-bit: of the 2-bit plane's
    and the 1-bit plane's fields), in float32 (exact below 2^24)."""
    c = unpack(packed, nbits, superblock, dtype=torch.int64)[:, :N]
    if nbits == 3:
        c = (c >> 1) + (c & 1)
    return c.sum(0).to(torch.float32)


def fma_only_plain(x, packed, scale, zero, *, nbits, group_size, shape,
                   superblock, up=None) -> torch.Tensor:
    """fma_only's y: every code 129 (3-bit: the 2-bit plane weighs 2, so
    387), ``x @ ((C - z) * s)`` in float32, rounded to x's dtype."""
    N, K = shape
    if up is not None:
        x = qm.swiglu_plain(x, up)
    C = 387.0 if nbits == 3 else 129.0
    w = ((C - zero.float()) * scale.float()).repeat_interleave(group_size, 0)
    return torch.matmul(x.float(), w[:K, :N]).to(x.dtype)


def const_code_plain(x, scale, zero, *, group_size, shape,
                     up=None) -> torch.Tensor:
    """mma_only's y: the grouped form (``qmm_grouped_plain``) with every
    code 1, ``sum_g s_g * (129 xsum_g) - s_g * (z_g + 128) * xsum_g`` over
    the bf16 activations' f32 group sums, rounded to x's dtype."""
    N, K = shape
    if up is not None:
        x = qm.swiglu_plain(x, up)
    G = scale.shape[0]
    xb = F.pad(x.to(torch.bfloat16).float(), (0, G * group_size - K))
    xsum = xb.reshape(-1, G, group_size).sum(2)               # [M, G]
    s, z = scale.float(), zero.float()
    return (xsum @ (s * (129.0 - (z + 128.0))))[:, :N].to(x.dtype)


def fragment_fold(packed, nbits, superblock, N) -> torch.Tensor:
    """The grouped ext_only's fold: per column the XOR of every A fragment
    the grouped consumer extracts, bf16 pairs ``0x4300 | c << o`` of the
    column's codes at K rows 2j (low half) and 2j + 1 (high half), ``o``
    the round's field offset (2-bit: ``2 * (p % 3)`` for round p, the
    shifts folded into masks; 3/4-bit: 0; 3-bit codes recombined).  The
    constant 0x4300 cancels over the even count of K row pairs."""
    c = unpack(packed, nbits, superblock, dtype=torch.int32)[:, :N]
    if nbits == 2:
        k = torch.arange(c.shape[0], device=c.device)
        c = c << (2 * ((k % superblock) // (superblock // 8) % 3))[:, None]
    return wrap_int32(xor_fold(c[0::2]).long()
                      | xor_fold(c[1::2]).long() << 16)


def attrib_plain(variant, x, packed, scale, zero, *, nbits, group_size,
                 shape, superblock, up=None, body="grouped") -> AttribOut:
    """The plain version of one variant of one body (see the module
    note)."""
    N = shape[0]
    kw = dict(nbits=nbits, group_size=group_size, shape=tuple(shape),
              superblock=superblock)
    grouped = body == "grouped"
    if variant == "full":
        plain = qm.qmm_grouped_plain if grouped else qm.qmm_plain
        return AttribOut(plain(x, packed, scale, zero, up=up,
                               out_dtype=x.dtype, **kw), None, None)
    if variant == ("mma_only" if grouped else "fma_only"):
        y = (const_code_plain(x, scale, zero, group_size=group_size,
                              shape=shape, up=up) if grouped
             else fma_only_plain(x, packed, scale, zero, up=up, **kw))
        return AttribOut(y, xor_fold(packed[:, :N]), None)
    if variant == "ext_only":
        if grouped:
            return AttribOut(None, fragment_fold(packed, nbits, superblock,
                                                 N), None)
        return AttribOut(None, meta_fold(scale, zero, N),
                         code_sums(packed, nbits, superblock, N))
    if variant == "load_only":
        return AttribOut(None, xor_fold(packed[:, :N])
                         ^ meta_fold(scale, zero, N), None)
    raise ValueError(f"unknown variant {variant!r} of body {body!r}")


# ---------------------------------------------------------------------------
# kernel launch

@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("gemv_attrib").amq_gemv_attrib
    fn.argtypes = ([_c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,
                    _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr] + [_c_int] * 13
                   + [ctypes.c_uint, _c_ptr])
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _occupancy_fn():
    fn = _cuda.library("gemv_attrib").amq_gemv_attrib_occupancy
    fn.argtypes = [_c_int] * 7 + [ctypes.POINTER(_c_int)]
    fn.restype = _c_int
    return fn


def occupancy(variant: str, body: str, *, nbits: int, superblock: int,
              group_size: int = 128, meta_bf16: bool = True,
              swiglu: bool = False) -> dict:
    """How one variant launches at a layout on the current card: blocks
    per SM (a stripped variant is held to ``full``'s), registers and local
    (spill) bytes per thread, dynamic shared memory bytes (the grouped
    body's ring grows with the SwiGLU operand)."""
    out = (_c_int * 4)()
    what = f"gemv_attrib occupancy ({body}, {variant}, {nbits}-bit)"
    _cuda.check(_occupancy_fn()(nbits, BODIES.index(body),
                                VARIANTS[body].index(variant), superblock,
                                group_size, int(meta_bf16), int(swiglu), out),
                what)
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))


def _attrib_cuda(variant, body, x, up, packed, scale, zero, *, nbits,
                 group_size, shape, superblock, acc) -> AttribOut:
    N, K = shape
    rows, Np = packed.shape
    Kp = rows * 32 // nbits
    what = f"gemv_attrib ({body}, {variant}, {nbits}-bit, N={N}, K={K})"
    if nbits not in (2, 3, 4):
        raise ValueError(f"{what}: no kernel for {nbits}-bit")
    tensors = [x, packed, scale, zero] + ([up] if up is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if packed.dtype != torch.int32 or scale.dtype != zero.dtype:
        raise TypeError(f"{what}: packed must be int32 and scale/zero alike")
    if x.shape != (1, K) or x.stride(1) != 1:
        raise ValueError(f"{what}: x must be [1, K] with unit column stride, "
                         f"got {tuple(x.shape)}")
    if up is not None and (up.shape != x.shape or up.stride() != x.stride()
                           or up.dtype != x.dtype):
        raise ValueError(f"{what}: up must match x in shape, strides, dtype")
    if not all(t.is_contiguous() for t in (packed, scale, zero)):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    if (Kp % superblock or superblock % 64 or superblock % group_size
            or superblock > 1024 or K > Kp or N > Np
            or scale.shape != (Kp // group_size, Np)
            or zero.shape != scale.shape):
        raise ValueError(f"{what}: packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)} do not fit")
    grouped = body == "grouped"
    if grouped and not qm._grouped_applies(x, packed, scale, zero, nbits,
                                           group_size, superblock, up):
        raise ValueError(f"{what}: the grouped body takes the calls the "
                         f"grouped ring takes (ops.quant_matmul."
                         f"_grouped_applies)")
    xr, cs = acc if acc is not None else (
        torch.zeros(N, dtype=torch.int32, device=x.device),
        torch.zeros(N, dtype=torch.float32, device=x.device))
    has_y = variant in ("full", "fma_only", "mma_only")
    # each body's production splits (the grouped ones count ring stages)
    splits, per = (qm._grouped_plan(N, Kp, nbits, up is not None,
                                    _cuda.dtype_flag(scale, what),
                                    group_size, superblock,
                                    x.device.index or 0) if grouped
                   else qm._splits(1, N, Kp // superblock, x.device))
    y = torch.empty((1, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, 1, N), dtype=torch.float32,
                           device=x.device)
               if splits > 1 and has_y else None)
    rc = _lib()(_cuda.ptr(x), _cuda.ptr(up), _cuda.dtype_flag(x, what),
                _cuda.ptr(packed), _cuda.ptr(scale), _cuda.ptr(zero),
                _cuda.dtype_flag(scale, what), _cuda.ptr(y),
                _cuda.dtype_flag(y, what), _cuda.ptr(partial), _cuda.ptr(xr),
                _cuda.ptr(cs), 1, K, x.stride(0), Kp, N, Np, nbits,
                group_size, superblock, splits, per, BODIES.index(body),
                VARIANTS[body].index(variant), 0, _cuda.stream())
    _cuda.check(rc, what)
    return AttribOut(y if has_y else None,
                     xr if variant != "full" else None,
                     cs if variant == "ext_only" and not grouped else None)


def gemv_attrib(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, *, nbits: int, group_size: int, shape,
                superblock: int, variant: str = "full", body: str = "grouped",
                up: Optional[torch.Tensor] = None, acc=None) -> AttribOut:
    """One variant of the attribution kernel's body on one layer: x [1, K]
    (with ``up`` the SwiGLU activation silu(x) * up) against ``packed
    [Kp*b/32, Np]``, ``scale`` / ``zero [Kp/g, Np]``.

    Replaces the Pallas kernel of ``scripts/kernel_attrib.py`` (``_kernel``).
    ``acc`` is an optional ``(xr, cs)`` pair the kernel folds into (XOR,
    add); by default fresh zeros.  A CPU tensor takes
    :func:`attrib_plain`; a CUDA tensor launches ``csrc/gemv_attrib.cu`` or
    raises.
    """
    if body not in BODIES or variant not in VARIANTS[body]:
        raise ValueError(f"variant {variant!r}, body {body!r}")
    kw = dict(nbits=nbits, group_size=group_size, shape=tuple(shape),
              superblock=superblock)
    if x.device.type == "cpu":
        return attrib_plain(variant, x, packed, scale, zero, up=up,
                            body=body, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _attrib_cuda(variant, body, x, up, packed, scale, zero, acc=acc,
                       **kw)
    gemv_attrib.launches += 1
    return out


gemv_attrib.launches = 0


_SASS_FN = re.compile(
    r"Function : \S*attrib_(gemv|grouped)_(?:kernel|pinned)ILi(\d)ELi(\d)E")
_SASS_HEAD = re.compile(r"Function : (\S+)")
# the instruction's address has four hex digits or more (a kernel past
# 64 KB of code)
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
SASS_OPS = ("FFMA", "I2F", "LDG", "LDS", "HMMA", "LOP3", "SHF")


def _functions(text: str):
    """(symbol, SASS body) of each kernel in a ``cuobjdump -sass`` listing."""
    heads = list(_SASS_HEAD.finditer(text))
    for h, nxt in zip(heads, heads[1:] + [None]):
        yield h, text[h.end():nxt.start() if nxt else len(text)]


def count_sass(text: str) -> list:
    """Per attribution kernel in a ``cuobjdump -sass`` listing: its body,
    width, variant and how many FFMA, I2F (int->float; also I2FP), LDG,
    LDS, HMMA (the grouped body's tensor-core products), LOP3 and SHF
    (extraction) instructions it holds."""
    recs = []
    for h, body in _functions(text):
        fn = _SASS_FN.match(h.group(0))
        if fn is None:
            continue
        ops = [op[:3] if op.startswith("I2F") else op
               for op in _SASS_OP.findall(body)]
        recs.append(dict(body=fn.group(1), nbits=int(fn.group(2)),
                         variant=VARIANTS[fn.group(1)][int(fn.group(3))],
                         **{op: ops.count(op) for op in SASS_OPS}))
    return sorted(recs, key=lambda r: (
        r["body"], r["nbits"], VARIANTS[r["body"]].index(r["variant"])))


def count_ops(text: str, symbol: str, ops) -> dict:
    """Per kernel in a ``cuobjdump -sass`` listing whose symbol matches the
    regex ``symbol``: how many instructions of each opcode in ``ops`` it
    holds (the opcode before its first dot, predicated ones too), keyed
    by the symbol."""
    recs = {}
    for h, body in _functions(text):
        if re.search(symbol, h.group(1)):
            found = _SASS_OP.findall(body)
            recs[h.group(1)] = {op: found.count(op) for op in ops}
    return recs


def count_forms(text: str, symbol: str, forms: dict) -> dict:
    """Per kernel whose symbol matches ``symbol``: how many of its
    instructions match each regex of ``forms`` (name -> regex over the
    whole instruction, e.g. ``HMMA\\.\\S*TF32`` for an operand type)."""
    return {h.group(1): {name: len(re.findall(rx, body))
                         for name, rx in forms.items()}
            for h, body in _functions(text) if re.search(symbol, h.group(1))}


def sass_listing(name: str) -> str:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu`` (needs
    ``cuobjdump`` beside ``nvcc``)."""
    _cuda.library(name)
    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(_cuda._lib_path(name))],
                          check=True, capture_output=True, text=True).stdout


def kernel_names(symbols) -> dict:
    """Short readable names of mangled kernel symbols, e.g.
    ``flash_kernel_wgmma<128>``, through ``c++filt`` (or ``cu++filt``);
    without either a symbol keeps its mangled name."""
    symbols = list(symbols)
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not symbols:
        return {sym: sym for sym in symbols}
    lines = subprocess.run([tool], input="\n".join(symbols), check=True,
                           capture_output=True, text=True).stdout.splitlines()
    names = {}
    for sym, line in zip(symbols, lines):
        # the kernel's own name: after its namespace, before its arguments
        # (which may name anonymous-namespace types too)
        name = line.split("(anonymous namespace)::", 1)[-1].split("(")[0]
        names[sym] = name.replace("__nv_bfloat16", "bf16") or sym
    return names


def sass_counts() -> list:
    """:func:`count_sass` of the built ``csrc/gemv_attrib.cu``."""
    return count_sass(sass_listing("gemv_attrib"))


# ---------------------------------------------------------------------------
# the probe

def _check(variant, got: AttribOut, want: AttribOut, prod) -> dict:
    """One variant against its plain version (and full against the route
    whose bits it carries, ``prod``): the numbers and whether they
    pass."""
    if variant == "full":
        rel = chain.rel_err(got.y, want.y)
        abs_err = (got.y.float() - want.y.float()).abs().max().item()
        equal = bool(torch.equal(got.y, prod))
        return dict(rel_err=rel, max_abs_err=abs_err, equal_production=equal,
                    ok=equal and rel <= FMA_TOL)
    rec = {}
    if got.y is not None:
        rec["rel_err"] = chain.rel_err(got.y, want.y)
        rec["max_abs_err"] = (got.y.float()
                              - want.y.float()).abs().max().item()
    rec["xr_equal"] = bool(torch.equal(got.xr, want.xr))
    if got.cs is not None:
        rec["cs_equal"] = bool(torch.equal(got.cs, want.cs))
    rec["ok"] = (rec["xr_equal"] and rec.get("cs_equal", True)
                 and rec.get("rel_err", 0.0) <= FMA_TOL)
    return rec


def production(body, x, up, packed, scale, zero, layer, **kw):
    """The route whose bits a body's ``full`` carries, on ``layer`` of the
    stack: the CUDA-core GEMV (``gemv``) or the public decode GEMV, which
    takes the grouped GEMV at bf16 and M <= 8 (``grouped``; on the CPU the
    grouped form's plain version, as the public wrappers there take the
    per-weight one)."""
    static = dict(out_dtype=x.dtype, **kw)
    if body == "gemv":
        return qm._qmm_cuda_core(x, packed[layer], scale[layer], zero[layer],
                                 up=up, **static)
    if x.device.type == "cpu":
        return qm.qmm_grouped_plain(x, packed[layer], scale[layer],
                                    zero[layer], up=up, **static)
    if up is None:
        return qm.quant_matmul_indexed(x, packed, scale, zero, layer, **static)
    return qm.quant_matmul_swiglu_indexed(x, up, packed, scale, zero, layer,
                                          **static)


def attrib_case(site: str, nbits: int, device) -> list:
    """Both bodies' four variants at one site and width: checks on layer 1,
    then (on a card) chain times over a 40-layer stack.  Returns one
    record per body; prints each as an ``ATTRIB`` line."""
    N, K = chain.SITES[site]
    on_card = device.type == "cuda"
    L = max(chain.CHAIN_LENS) if on_card else 2
    gen = torch.Generator(device=device).manual_seed(0)
    packed, scale, zero, sb = chain.random_stack(N, K, nbits, L, gen, device)
    x = torch.randn((1, K), generator=gen, device=device).to(torch.bfloat16)
    up = (torch.randn((1, K), generator=gen, device=device).to(torch.bfloat16)
          if site == "down" else None)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb)
    recs = []
    for body in BODIES:
        prod = production(body, x, up, packed, scale, zero, 1, **kw)
        checks, us = {}, {}
        for variant in VARIANTS[body]:
            got = gemv_attrib(x, packed[1], scale[1], zero[1], up=up,
                              variant=variant, body=body, **kw)
            want = attrib_plain(variant, x, packed[1], scale[1], zero[1],
                                up=up, body=body, **kw)
            checks[variant] = _check(variant, got, want, prod)
            if on_card:
                acc = (torch.zeros(N, dtype=torch.int32, device=device),
                       torch.zeros(N, dtype=torch.float32, device=device))
                us[variant] = chain.chain_us(
                    lambda i, v=variant: gemv_attrib(
                        x, packed[i], scale[i], zero[i], up=up, variant=v,
                        body=body, acc=acc, **kw))
        rec = dict(site=site, N=N, K=K, nbits=nbits, body=body,
                   bound_us=chain.bound_us(packed, scale, N), us=us or None,
                   checks=checks, ok=all(c["ok"] for c in checks.values()))
        if us:
            occ = {v: occupancy(v, body, nbits=nbits, superblock=sb,
                                swiglu=up is not None)
                   for v in VARIANTS[body]}
            blocks = occ["full"]["blocks_per_sm"]
            others = {v: t for v, t in us.items() if v != "full"}
            rec.update(
                occupancy=occ,
                pinned=all(o["blocks_per_sm"] == blocks
                           for o in occ.values()),
                slack_us=us["full"] - max(others.values()),
                load_only_share_of_bound=rec["bound_us"] / us["load_only"])
            # only at full's occupancy does a time say what full waits on
            rec["tracks_full"] = (min(others, key=lambda v: abs(
                others[v] - us["full"])) if rec["pinned"] else None)
        print("ATTRIB " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None, device=None) -> list:
    """``[site] [nbits...]`` (default ``o 2 4``, the script's); returns the
    records.  Runs on the card unless ``device="cpu"`` is asked for."""
    argv = list(sys.argv[1:] if argv is None else argv)
    site = argv[0] if argv else "o"
    bits = [int(b) for b in argv[1:]] or [2, 4]
    if site not in chain.SITES:
        raise SystemExit(f"site {site!r}: one of {sorted(chain.SITES)}")
    dev = resolve_device(device)
    N, K = chain.SITES[site]
    print(f"site={site} N={N} K={K} device={dev}", flush=True)
    return [r for nb in bits for r in attrib_case(site, nb, dev)]


if __name__ == "__main__":
    main()
