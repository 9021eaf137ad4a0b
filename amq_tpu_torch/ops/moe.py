"""Routed experts of a sparse (Qwen2-MoE) layer: wrappers and plain versions.

The JAX package has no mixture-of-experts layer, so nothing here replaces
a Pallas kernel; ``csrc/moe_experts.cu`` was written for Qwen2-57B-A14B,
whose routed experts hold ~80 % of a decode step's bytes.  A layer's
experts run in three steps, each capturable (the grouping by expert is
computed and read on the device only):

* :func:`route` -- the router in float32: ``softmax(h W_g^T)`` over the
  experts, the top ``k`` with their probabilities (renormalised only with
  ``norm_topk_prob``).  Plain PyTorch on every device.
* :func:`moe_align` -- the step's (row, expert) pairs laid out by expert,
  each expert padded to whole row tiles (``moe_align_kernel``); its plain
  version :func:`align_plain` gives the same layout with each expert's
  pairs in pair order (the kernel's order inside an expert is its
  atomics').  The kernel also adds the experts hit, the pairs and the
  experts offered to the per-layer device counters
  (:func:`device_counters`).
* :func:`moe_experts` -- every pair's ``down(silu(gate x) * up x)`` with
  its expert's packed weights: the align, then one gate|up and one down
  launch over the layout's tiles (``moe_gemv_kernel`` at most
  :data:`GEMV_ROWS` rows, tiles of 16; ``moe_tile_kernel`` above, tiles
  of 64).  An expert no pair chose is never read.  Plain version
  :func:`experts_plain`: per expert, its pairs' rows through the port's
  bf16 multi-row form (``quant_matmul.qmm_tile_plain``: the weight
  dequantized in bf16, rounding after each operation, f32 products) or,
  for float32 x, ``qmm_plain``; the gate|up output and the SwiGLU rounded
  to x's type, as the dense MLP's are.
* :func:`moe_combine` -- ``sum_k w_k y_k + sigmoid(s) * shared`` per row
  in float32, rounded once (``moe_combine_kernel``); plain
  :func:`combine_plain`.

The kernels take bf16 activations and 2- or 4-bit containers (the serving
stacks; 3-bit codes ride 4-bit containers) with K a whole number of
superblocks; a CUDA call outside that raises, a CPU tensor takes the plain
version.  Each wrapper counts its launches (``<wrapper>.launches``);
``moe_experts.gemv_launches`` / ``tile_launches`` count the calls per
form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .quant_matmul import qmm_plain, qmm_tile_plain, swiglu_plain

#: calls of at most this many rows take the decode form (row tiles of 16:
#: each row picks an expert once, so one tile per expert hit)
GEMV_ROWS = 8
#: rows of a tile per form
TILE_ROWS = {"gemv": 16, "tile": 64}
#: the align kernel's bound on the experts of a layer
MAX_EXPERTS = 256
#: layers the device counters hold
MAX_LAYERS = 256

_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

#: what the device counters count, in their second dimension
COUNTS = ("experts_hit", "pairs", "experts")

#: per device: int64 ``[2 forms (gemv, tile), COUNTS, MAX_LAYERS]``, fixed
#: in place so captured graphs keep adding to it
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def device_counters(device) -> torch.Tensor:
    """The device's running counts ``[form, COUNTS, layer]`` (form 0 the
    decode form, 1 the multi-row one): per layer, summed over the align
    calls, the distinct experts each found, the pairs it laid out and the
    layer's experts (hit or not).  Made zero at first use; never
    reallocated (``zero_()`` to reset)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _COUNTERS.get(device)
    if c is None:
        with torch.inference_mode(False):
            c = torch.zeros((2, len(COUNTS), MAX_LAYERS), dtype=torch.int64,
                            device=device)
        _COUNTERS[device] = c
    return c


def form(rows: int) -> str:
    """The expert product's form at ``rows`` activation rows."""
    return "gemv" if rows <= GEMV_ROWS else "tile"


def tiles_bound(pairs: int, experts: int, bm: int) -> int:
    """Row tiles the layout can need: ``sum_e ceil(c_e / bm)`` over at most
    ``min(experts, pairs)`` experts with counts summing to ``pairs``."""
    return pairs // bm + min(experts, pairs)


@functools.lru_cache(maxsize=None)
def _fn(entry: str):
    fn = getattr(_cuda.library("moe_experts"), entry)
    p, i, ll = _c_ptr, _c_int, _c_ll
    fn.argtypes = {
        "amq_moe_align": [p, i, i, i, i, p, p, p, i, p],
        "amq_moe_experts": [i, p, p, p, p, ll, ll, p, p, p, i, i, i, i, i,
                            i, i, p],
        "amq_moe_combine": [p, p, p, p, p, i, i, i, p],
    }[entry]
    fn.restype = i
    return fn


# ---------------------------------------------------------------------------
# routing

def route(x: torch.Tensor, router: torch.Tensor, k: int,
          norm_topk_prob: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(weights [M, k] float32, experts [M, k] int64)`` of rows ``x [M,
    H]`` under the router ``[E, H]``: logits and softmax in float32, the
    top ``k`` probabilities in descending order."""
    logits = torch.matmul(x.float(), router.float().T)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, experts


# ---------------------------------------------------------------------------
# align

def align_plain(ids: torch.Tensor, num_experts: int, bm: int,
                tiles: Optional[int] = None):
    """``(sorted [tiles * bm] int32, tile_expert [tiles] int32, hits)`` of
    the pair experts ``ids`` (any shape, flattened: pair p is row p // k,
    choice p % k): experts in order, each one's pairs in pair order padded
    with -1 to whole tiles of ``bm``; tiles past the last expert's hold -1.
    ``hits`` is the number of experts with a pair."""
    flat = ids.reshape(-1).long().cpu()
    P = flat.numel()
    tiles = tiles_bound(P, num_experts, bm) if tiles is None else tiles
    sorted_ = torch.full((tiles * bm,), -1, dtype=torch.int32)
    tile_expert = torch.full((tiles,), -1, dtype=torch.int32)
    at, hits = 0, 0
    for e in range(num_experts):
        pairs = torch.nonzero(flat == e)[:, 0]
        if not len(pairs):
            continue
        hits += 1
        sorted_[at:at + len(pairs)] = pairs.to(torch.int32)
        n_t = -(-len(pairs) // bm)
        tile_expert[at // bm:at // bm + n_t] = e
        at += n_t * bm
    return sorted_.to(ids.device), tile_expert.to(ids.device), hits


def moe_align(ids: torch.Tensor, num_experts: int, bm: int, tiles: int,
              layer: int = 0, form_index: int = 0):
    """:func:`align_plain`'s layout on the device (``moe_align_kernel``,
    one launch), adding to ``device_counters[form_index, :, layer]``.
    Returns ``(sorted,
    tile_expert)``; CPU tensors take the plain version (and count
    nothing)."""
    if ids.device.type == "cpu":
        s, t, _ = align_plain(ids, num_experts, bm, tiles)
        return s, t
    if ids.device.type != "cuda":
        raise ValueError(f"no kernel for device {ids.device}")
    what = f"moe_align (P={ids.numel()}, E={num_experts}, bm={bm})"
    if ids.dtype != torch.int64 or not ids.is_contiguous():
        raise ValueError(f"{what}: ids must be contiguous int64")
    if not 0 < num_experts <= MAX_EXPERTS or not 0 <= layer < MAX_LAYERS:
        raise ValueError(f"{what}: experts or layer out of range")
    P = ids.numel()
    sorted_ = torch.empty((tiles * bm,), dtype=torch.int32, device=ids.device)
    tile_expert = torch.empty((tiles,), dtype=torch.int32, device=ids.device)
    c = device_counters(ids.device)
    ptr = _cuda.ptr
    rc = _fn("amq_moe_align")(
        ptr(ids), P, num_experts, bm, tiles, ptr(sorted_), ptr(tile_expert),
        ptr(c[form_index, 0, layer:]), MAX_LAYERS, _cuda.stream())
    _cuda.check(rc, what)
    moe_align.launches += 1
    return sorted_, tile_expert


moe_align.launches = 0


# ---------------------------------------------------------------------------
# expert products

def _expert_product(x, packed, scale, zero, *, nbits, group_size, superblock,
                    shape, out_dtype, up=None):
    fn = qmm_tile_plain if x.dtype == torch.bfloat16 else qmm_plain
    return fn(x, packed, scale, zero, nbits=nbits, group_size=group_size,
              shape=shape, superblock=superblock, out_dtype=out_dtype, up=up)


def experts_plain(x, ids, gu_packed, gu_scale, gu_zero, dn_packed, dn_scale,
                  dn_zero, first: int, *, num_experts: int, nbits: int,
                  group_size: int, gu_superblock: int, dn_superblock: int,
                  out_dtype=None) -> torch.Tensor:
    """``y [M * k, H]``: pair p (row p // k, expert ``ids[p // k, p % k]``)
    through its expert's gate|up (``first + e`` of the stacks), SwiGLU and
    down, each product rounded to ``out_dtype`` as the dense MLP's are."""
    out_dtype = out_dtype or x.dtype
    M, H = x.shape
    k = ids.shape[1]
    I2 = gu_packed.shape[-1]
    flat = ids.reshape(-1)
    y = torch.zeros((M * k, dn_packed.shape[-1]), dtype=out_dtype,
                    device=x.device)
    for e in range(num_experts):
        pairs = torch.nonzero(flat == e)[:, 0]
        if not len(pairs):
            continue
        w = first + e
        gu = _expert_product(x[pairs // k], gu_packed[w], gu_scale[w],
                             gu_zero[w], nbits=nbits, group_size=group_size,
                             superblock=gu_superblock, shape=(I2, H),
                             out_dtype=out_dtype)
        y[pairs] = _expert_product(
            gu[:, :I2 // 2], dn_packed[w], dn_scale[w], dn_zero[w],
            nbits=nbits, group_size=group_size, superblock=dn_superblock,
            shape=(dn_packed.shape[-1], I2 // 2), out_dtype=out_dtype,
            up=gu[:, I2 // 2:])
    return y


def _check_stack(what, packed, scale, zero, nbits, superblock, K):
    if packed.dtype != torch.int32 or scale.dtype != torch.bfloat16 \
            or zero.dtype != torch.bfloat16:
        raise TypeError(f"{what}: int32 words and bf16 scale / zero wanted")
    if not all(t.is_contiguous() for t in (packed, scale, zero)):
        raise ValueError(f"{what}: stacks must be contiguous")
    if packed.shape[1] * 32 // nbits != K or K % superblock:
        raise ValueError(f"{what}: K {K} is not the stack's "
                         f"{packed.shape[1] * 32 // nbits} whole superblocks "
                         f"of {superblock}")


def moe_experts(x: torch.Tensor, ids: torch.Tensor, gu_packed, gu_scale,
                gu_zero, dn_packed, dn_scale, dn_zero, first: int, *,
                num_experts: int, nbits: int, group_size: int,
                gu_superblock: int, dn_superblock: int, out_dtype=None,
                layer: int = 0) -> torch.Tensor:
    """``y [M * k, H]`` of :func:`experts_plain` through the kernels on a
    CUDA tensor: :func:`moe_align`, then the gate|up and the down product
    over the layout's tiles.  The stacks are ``[E', Kp * nbits / 32, N]``
    words (no lane pad) with ``[E', Kp / group, N]`` bf16 scale and zero;
    the layer's experts are ``first .. first + num_experts - 1``.
    ``layer`` picks the device counters' column."""
    if x.device.type == "cpu":
        return experts_plain(
            x, ids, gu_packed, gu_scale, gu_zero, dn_packed, dn_scale,
            dn_zero, first, num_experts=num_experts, nbits=nbits,
            group_size=group_size, gu_superblock=gu_superblock,
            dn_superblock=dn_superblock, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    M, H = x.shape
    k = ids.shape[1]
    I2, N = gu_packed.shape[-1], dn_packed.shape[-1]
    what = f"moe_experts ({nbits}-bit, M={M}, H={H}, I={I2 // 2}, k={k})"
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError(f"{what}: the kernels take bf16 activations and out")
    if group_size != 128 or nbits not in (2, 4) or N != H:
        raise ValueError(f"{what}: group {group_size}, {nbits}-bit "
                         "containers or down's N do not fit the kernels")
    _check_stack(what, gu_packed, gu_scale, gu_zero, nbits, gu_superblock, H)
    _check_stack(what, dn_packed, dn_scale, dn_zero, nbits, dn_superblock,
                 I2 // 2)
    x = x.contiguous()
    P = M * k
    f = form(M)
    bm = TILE_ROWS[f]
    tiles = tiles_bound(P, num_experts, bm)
    sorted_, tile_expert = moe_align(ids.contiguous(), num_experts, bm,
                                     tiles, layer, int(f == "tile"))
    act = torch.empty((tiles * bm, I2 // 2), dtype=torch.bfloat16,
                      device=x.device)
    y = torch.empty((P, N), dtype=torch.bfloat16, device=x.device)
    ptr, fn = _cuda.ptr, _fn("amq_moe_experts")
    for gateup, src, (pk, sc, ze), sb, dst, K, n in (
            (1, x, (gu_packed, gu_scale, gu_zero), gu_superblock, act, H, I2),
            (0, act, (dn_packed, dn_scale, dn_zero), dn_superblock, y,
             I2 // 2, N)):
        rc = fn(gateup, ptr(src), ptr(pk[first]), ptr(sc[first]),
                ptr(ze[first]), pk[0].numel(), sc[0].numel(), ptr(sorted_),
                ptr(tile_expert), ptr(dst), K, n, nbits, sb, k, bm, tiles,
                _cuda.stream())
        _cuda.check(rc, what)
    moe_experts.launches += 2
    if f == "gemv":
        moe_experts.gemv_launches += 2
    else:
        moe_experts.tile_launches += 2
    return y


moe_experts.launches = 0
#: launches of the decode form (tiles of 16) and of the multi-row form
moe_experts.gemv_launches = 0
moe_experts.tile_launches = 0


# ---------------------------------------------------------------------------
# combine

def combine_plain(y: torch.Tensor, weights: torch.Tensor,
                  shared: torch.Tensor, shared_logit: torch.Tensor,
                  out_dtype=None) -> torch.Tensor:
    """``[M, H]``: ``sum_k weights[m, k] y[m k + k] + sigmoid(s[m]) *
    shared[m]`` in float32, rounded once to ``out_dtype``."""
    M, k = weights.shape
    routed = (weights.float()[:, :, None]
              * y.float().reshape(M, k, -1)).sum(dim=1)
    gate = torch.sigmoid(shared_logit.float())[:, None]
    return (routed + gate * shared.float()).to(out_dtype or shared.dtype)


def moe_combine(y: torch.Tensor, weights: torch.Tensor, shared: torch.Tensor,
                shared_logit: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """:func:`combine_plain` through ``moe_combine_kernel`` on a CUDA
    tensor (bf16 ``y``, ``shared`` and out; float32 weights and logits)."""
    if y.device.type == "cpu":
        return combine_plain(y, weights, shared, shared_logit, out_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    M, k = weights.shape
    H = shared.shape[-1]
    what = f"moe_combine (M={M}, k={k}, H={H})"
    if (y.dtype != torch.bfloat16 or shared.dtype != torch.bfloat16
            or (out_dtype or shared.dtype) != torch.bfloat16):
        raise TypeError(f"{what}: bf16 pair outputs, shared output and out")
    if H % 8 or y.shape != (M * k, H):
        raise ValueError(f"{what}: y {tuple(y.shape)} does not fit")
    y, shared = y.contiguous(), shared.contiguous()
    w = weights.float().contiguous()
    s = shared_logit.float().contiguous()
    out = torch.empty((M, H), dtype=torch.bfloat16, device=y.device)
    ptr = _cuda.ptr
    rc = _fn("amq_moe_combine")(ptr(y), ptr(w), ptr(shared), ptr(s),
                                ptr(out), M, k, H, _cuda.stream())
    _cuda.check(rc, what)
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


def counter_rise(before: torch.Tensor, after: torch.Tensor) -> Dict:
    """``{form: {count: total}}`` of what the device counters rose by
    between two host copies of :func:`device_counters`, plus per form
    ``"experts_hit_by_layer"``."""
    d = (after - before).tolist()
    out = {}
    for f, name in enumerate(("gemv", "tile")):
        out[name] = {c: int(sum(d[f][j])) for j, c in enumerate(COUNTS)}
        out[name]["experts_hit_by_layer"] = [int(v) for v in d[f][0]]
    return out


def fold_counters(tracer, before: torch.Tensor,
                  after: torch.Tensor) -> None:
    """Add the device counters' rise (both forms) to ``tracer``'s
    ``moe.experts_hit`` and ``moe.experts`` counters: the device-side
    counts, read once a profiled slice has ended."""
    rise = counter_rise(before, after)
    for c in ("experts_hit", "experts"):
        tracer.counters[f"moe.{c}"] += sum(r[c] for r in rise.values())

