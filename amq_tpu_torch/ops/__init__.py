"""Hand-written CUDA kernels of the port and their plain versions.

``KERNELS`` lists each kernel's wrapper; every wrapper carries a
``launches`` counter that counts its kernel launches (never a plain-version
call).  ``GROUPED`` lists the wrappers whose decode calls may take the
grouped tensor-core GEMV; their ``grouped_launches`` count those (and
``span_launches`` those of them whose superblocks span a ring stage),
and their ``tile_launches`` the multi-row calls that took the tile kernel
on wgmma (``pair_launches`` and ``pair_tile_launches``: the grouped and
tile launches at 4-row superblocks, the pair forms); ``flash_attention.f32_launches`` counts the flash launches on
float32 inputs (the split-TF32 kernel) and
``decode_attention_indexed.split_launches`` the decode-attention calls that
split a row's keys across blocks (and merged them); the routed experts'
``moe_align``, ``moe_experts`` (two launches a call, with
``gemv_launches`` / ``tile_launches`` per form) and ``moe_combine`` count
theirs too.  A captured CUDA graph launches
its kernels on every replay without calling a wrapper: ``serving.graphs``
adds a replay's launches with
:func:`add_launch_counts` (and takes back those of its warm-up and
capture, which run the wrappers but are undone or launch nothing).
"""

from . import decode_attention as _attn
from . import dequant as _dequant
from . import flash_attention as _flash
from . import moe as _moe
from . import quant_matmul as _qmm

KERNELS = (_qmm.quant_matmul_indexed, _qmm.quant_matmul_swiglu_indexed,
           _attn.decode_attention_indexed, _qmm.quant_matmul,
           _flash.flash_attention, _qmm.quant_matmul_indexed_pipe,
           _qmm.quant_matmul_swiglu_indexed_pipe,
           _qmm.quant_matmul_mlp_indexed, _dequant.dequantize_kn,
           _moe.moe_align, _moe.moe_experts, _moe.moe_combine)
GROUPED = (_qmm.quant_matmul_indexed, _qmm.quant_matmul_swiglu_indexed,
           _qmm.quant_matmul)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in GROUPED:
        fn.grouped_launches = 0
        fn.span_launches = 0
        fn.tile_launches = 0
        fn.pair_launches = 0
        fn.pair_tile_launches = 0
    _flash.flash_attention.f32_launches = 0
    _attn.decode_attention_indexed.split_launches = 0
    _moe.moe_experts.gemv_launches = 0
    _moe.moe_experts.tile_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def grouped_launch_counts() -> dict:
    return {fn.__name__: fn.grouped_launches for fn in GROUPED}


def span_launch_counts() -> dict:
    return {fn.__name__: fn.span_launches for fn in GROUPED}


def tile_launch_counts() -> dict:
    return {fn.__name__: fn.tile_launches for fn in GROUPED}


def pair_launch_counts() -> dict:
    """Per wrapper the (grouped, tile) launches at 4-row superblocks."""
    return {fn.__name__: (fn.pair_launches, fn.pair_tile_launches)
            for fn in GROUPED}


def counter_state() -> dict:
    """Every counter above: ``{(wrapper, attribute): count}``."""
    state = {(fn, "launches"): fn.launches for fn in KERNELS}
    for fn in GROUPED:
        state[(fn, "grouped_launches")] = fn.grouped_launches
        state[(fn, "span_launches")] = fn.span_launches
        state[(fn, "tile_launches")] = fn.tile_launches
        state[(fn, "pair_launches")] = fn.pair_launches
        state[(fn, "pair_tile_launches")] = fn.pair_tile_launches
    state[(_flash.flash_attention, "f32_launches")] = \
        _flash.flash_attention.f32_launches
    state[(_attn.decode_attention_indexed, "split_launches")] = \
        _attn.decode_attention_indexed.split_launches
    for attr in ("gemv_launches", "tile_launches"):
        state[(_moe.moe_experts, attr)] = getattr(_moe.moe_experts, attr)
    return state


def count_delta(after: dict, before: dict) -> dict:
    """The counters' rise from ``before`` to ``after`` (non-zero only)."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`count_delta`) to the counters."""
    for (fn, attr), n in delta.items():
        setattr(fn, attr, getattr(fn, attr) + n * times)
