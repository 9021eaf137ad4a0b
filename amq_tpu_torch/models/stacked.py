"""Stacked-layer serving model: per-bit weight stacks, a per-layer branch.

The port of the serving subset of the JAX package's ``models/stacked.py``.
For every linear site the per-bit packed stacks ``[L, rows_b, Np]`` are
kept side by side, and a per-layer selector picks the stack a layer reads.
The JAX ``lax.scan`` over layers with a ``lax.switch`` per layer becomes a
Python loop with a host-side branch: ``select`` and ``slots`` stay host
lists, since reading a device selector per layer would synchronise the
card every layer.  Only the selected stack's layer is read, as a view.

While :class:`~.linear.kernel_linears` has a kernel implementation
installed, the linears run through the CUDA dequant-matmul kernels
(``ops.quant_matmul``) and single-token decode attention through the
decode-attention kernel (``ops.decode_attention``); large-M calls
(M >= ``_PREFILL_XLA_M``) dequantize and use a library matmul, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.quantize import QuantizedTensor, quantize, to_container
from ..parallel import comm
from ..utils.profiling import TRACER
from .config import LINEAR_NAMES, ModelConfig
from . import linear as linear_mod
from . import llama


@dataclasses.dataclass
class StackedQuant:
    """One linear site across layers at one bit-width."""

    packed: torch.Tensor   # int32 [L, Kp*b/32, Np]
    scale: torch.Tensor    # [L, Kp/g, Np]
    zero: torch.Tensor     # [L, Kp/g, Np]
    nbits: int
    group_size: int
    shape: tuple           # logical (out, in)
    superblock: int = 0

    def layer(self, i: int) -> QuantizedTensor:
        return QuantizedTensor(packed=self.packed[i], scale=self.scale[i],
                               zero=self.zero[i], nbits=self.nbits,
                               group_size=self.group_size, shape=self.shape,
                               superblock=self.superblock)


@dataclasses.dataclass
class StackedModel:
    """Whole decoder with stacked layers and per-layer bit selectors."""

    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]             # [vocab, H] or None (tied)
    input_norm: torch.Tensor                    # [L, H]
    post_norm: torch.Tensor                     # [L, H]
    sites: Dict[str, Tuple[StackedQuant, ...]]  # name -> per-bit stacks
    biases: Dict[str, Optional[torch.Tensor]]   # name -> [L, out] or None
    select: Dict[str, List[int]]                # name -> per-layer stack index
    bits_range: tuple
    num_layers: int
    #: every site shares one per-layer selector
    uniform_select: bool = False
    #: container-merged models: per-layer index into the compact stacks
    slots: Optional[List[int]] = None
    #: packed lm_head (stack_proxies(head_bits=...)); replaces lm_head/embed
    #: in the logits matmul when set
    lm_head_qt: Optional[QuantizedTensor] = None
    #: sparse (Qwen2-MoE) models, ``models.moe.stack_moe``: the router
    #: ``[L, E, H]`` and the shared expert's gate ``[L, H]`` (float32
    #: holding bf16 values, unquantized), and the routed experts' fused
    #: sites ``mlp.experts.gateup_proj`` / ``mlp.experts.down_proj``:
    #: per-container stacks ``[layers * E, rows, N]`` (no lane pad) whose
    #: row ``slot * E + e`` is expert e of the layer in that slot; the
    #: shared expert is two ordinary sites of ``sites``
    router: Optional[torch.Tensor] = None
    shared_gate: Optional[torch.Tensor] = None
    experts: Optional[Dict[str, Tuple[StackedQuant, ...]]] = None


# fused site groups: one kernel launch for q/k/v and for gate/up (same
# input, outputs concatenated along N); valid when each group's members
# have equal bits in every layer
FUSED_GROUPS = {
    "self_attn.qkv_proj": ("self_attn.q_proj", "self_attn.k_proj",
                           "self_attn.v_proj"),
    "mlp.gateup_proj": ("mlp.gate_proj", "mlp.up_proj"),
}

#: serving default: 3-bit codes ride 4-bit containers (pass {} for native
#: 3-bit packing)
SERVE_CONTAINERS = {3: 4}

#: token count at/above which stacked linears dequantize and use a library
#: matmul instead of the kernels (the JAX package's XLA route)
_PREFILL_XLA_M = 256


def _pick_lane_pad(n_total: int) -> int:
    """Zero lanes appended to a site's N, the JAX package's tile choice:
    the smaller pad of the 2560 and 2048 multiples when bounded by n/7
    (ties -> fewer tiles), else a 1024 multiple when bounded, else 0.
    Pad columns are zero and never returned by the kernels."""
    bound = n_total // 7
    best = None                       # (pad, steps, mult)
    for mult in (2560, 2048):
        pad = -n_total % mult
        key = (pad, (n_total + pad) // mult)
        if pad <= bound and (best is None or key < best[:2]):
            best = key + (mult,)
    if best is not None:
        return best[0]
    pad = -n_total % 1024
    return pad if pad <= bound else 0


def _arch_fusable(arch: Optional[Dict], L: int) -> bool:
    if arch is None:
        return True
    for members in FUSED_GROUPS.values():
        for i in range(L):
            if len({int(arch["linear"][m][i]) for m in members}) > 1:
                return False
    return True


def _selectors_uniform(select: Dict[str, List[int]]) -> bool:
    sels = [list(s) for s in select.values()]
    return all(s == sels[0] for s in sels[1:])


def quantize_head(head_w: torch.Tensor, nbits: int = 8, group_size: int = 128,
                  meta_dtype=torch.bfloat16,
                  lane_tile: int = 2048) -> QuantizedTensor:
    """Quantize a ``[vocab, H]`` lm_head for packed serving; the vocab is
    zero-padded to a multiple of ``lane_tile`` (``shape`` stays logical)."""
    V, H = head_w.shape
    Wp = F.pad(head_w.float(), (0, 0, 0, -V % lane_tile))
    qt = quantize(Wp, nbits=nbits, group_size=group_size, meta_dtype=meta_dtype)
    return dataclasses.replace(qt, shape=(V, H))


def apply_head(model: StackedModel, x: torch.Tensor, compute_dtype):
    """Logits matmul: packed head when quantized, dense otherwise.
    x: [..., H] -> [..., vocab] float32."""
    if model.lm_head_qt is not None:
        from ..ops.quant_matmul import quant_matmul
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if linear_mod.kernels_active() and x2.shape[0] < _PREFILL_XLA_M:
            out = quant_matmul(x2, model.lm_head_qt, out_dtype=torch.float32)
        else:                  # dequantize (in x's dtype), then f32 matmul
            wt = linear_mod.dequantize_weight(model.lm_head_qt, x2.dtype)
            out = torch.matmul(x2.float(), wt.float())
        return out.reshape(*lead, model.lm_head_qt.out_features)
    head = model.lm_head if model.lm_head is not None else model.embed
    return linear_mod.matmul_out_f32(x, head.T, compute_dtype)


def stack_proxies(proxies: Sequence[Any], bits_range: Sequence[int],
                  arch: Optional[Dict] = None,
                  fuse: str = "auto",
                  container_bits: Optional[Dict[int, int]] = None,
                  head_bits: Optional[int] = None,
                  lane_pad: bool = True) -> StackedModel:
    """Fold per-bit quantized parameter dicts (``quantize_model`` outputs,
    or zero-argument callables returning them, built and freed one at a
    time) into a :class:`StackedModel`.

    ``fuse``: 'auto' fuses q/k/v and gate/up into one site each when the
    arch gives their members equal bits in every layer, 'never' keeps the
    seven sites (an evaluation switch model that any arch can be set on).
    With ``lane_pad`` each site's N is zero-padded by
    :func:`_pick_lane_pad` (the decode kernels' tiles; the evaluation path
    dequantizes and needs no pad).  ``container_bits`` maps a logical width
    to its packed container (``SERVE_CONTAINERS``); ``head_bits`` packs the
    lm_head (or the tied embedding's logits role) at that width with bf16
    scale/zero.  Stacks stay on the device the proxies' tensors live on.
    """
    container_bits = container_bits or {}
    bits_range = list(bits_range)
    site_names: Optional[Dict[str, Tuple[str, ...]]] = None
    per_bit: Dict[str, List[StackedQuant]] = {}
    biases: Dict[str, Optional[torch.Tensor]] = {}
    select: Dict[str, List[int]] = {}
    base: Dict[str, Any] = {}

    for bi, (bit, p) in enumerate(zip(bits_range, proxies)):
        if callable(p):
            p = p()
        L = len(p["layers"])
        if site_names is None:
            site_names = (
                {**FUSED_GROUPS, "self_attn.o_proj": ("self_attn.o_proj",),
                 "mlp.down_proj": ("mlp.down_proj",)}
                if fuse == "auto" and _arch_fusable(arch, L)
                else {n: (n,) for n in LINEAR_NAMES})
            per_bit = {n: [] for n in site_names}
        for name, members in site_names.items():
            cont = container_bits.get(bit, bit)
            per_layer = [[to_container(p["layers"][i][m].qt, cont)
                          for m in members] for i in range(L)]
            q0 = per_layer[0][0]
            n_total = sum(q.shape[0] for q in per_layer[0])
            n_pad = _pick_lane_pad(n_total) if lane_pad else 0

            def stacked(field):
                return F.pad(torch.stack([
                    torch.cat([getattr(q, field) for q in qts], dim=1)
                    for qts in per_layer]), (0, n_pad))

            per_bit[name].append(StackedQuant(
                packed=stacked("packed"), scale=stacked("scale"),
                zero=stacked("zero"), nbits=q0.nbits,
                group_size=q0.group_size, shape=(n_total, q0.shape[1]),
                superblock=q0.superblock))
            del per_layer
        if bi == len(bits_range) - 1:          # dense parts from the last bit
            for name, members in site_names.items():
                if p["layers"][0][members[0]].bias is None:
                    biases[name] = None
                else:
                    biases[name] = torch.stack([
                        torch.cat([p["layers"][i][m].bias for m in members])
                        for i in range(L)])
                if arch is None:
                    select[name] = [len(bits_range) - 1] * L
                else:
                    select[name] = [bits_range.index(
                        int(arch["linear"][members[0]][i])) for i in range(L)]
            head = p.get("lm_head")
            base = {
                "embed": p["embed"], "final_norm": p["final_norm"],
                "head_w": None if head is None else head.weight,
                "input_norm": torch.stack([p["layers"][i]["input_norm"]
                                           for i in range(L)]),
                "post_norm": torch.stack([p["layers"][i]["post_norm"]
                                          for i in range(L)]),
                "L": L,
            }
        del p

    assert site_names is not None and base, "empty proxies"
    head_qt = None
    if head_bits is not None:
        head_w = base["head_w"] if base["head_w"] is not None else base["embed"]
        head_qt = quantize_head(head_w, nbits=head_bits)
    return StackedModel(
        embed=base["embed"], final_norm=base["final_norm"],
        lm_head=(None if base["head_w"] is None or head_qt is not None
                 else base["head_w"]),
        lm_head_qt=head_qt,
        input_norm=base["input_norm"], post_norm=base["post_norm"],
        sites={name: tuple(stacks) for name, stacks in per_bit.items()},
        biases=biases, select=select, bits_range=tuple(bits_range),
        num_layers=base["L"],
        uniform_select=arch is not None and _selectors_uniform(select))


def merge_containers(model: StackedModel) -> StackedModel:
    """Collapse per-bit stacks of equal container width into one compact
    stack per width holding exactly the layers assigned to it, plus a
    per-layer ``slots`` list into it.  Needs a layer-uniform arch."""
    assert model.uniform_select, "container merge needs a layer-uniform arch"
    first = next(iter(model.select))
    sel = list(model.select[first])
    widths = [model.sites[first][b].nbits for b in range(len(model.bits_range))]
    containers = sorted(set(widths))
    cont_of_bit = {b: containers.index(w) for b, w in enumerate(widths)}

    layer_cont = [cont_of_bit[b] for b in sel]
    used = [c for c in range(len(containers)) if c in layer_cont]
    remap = {c: j for j, c in enumerate(used)}
    layer_cont = [remap[c] for c in layer_cont]
    slots: List[int] = []
    members: List[List[int]] = [[] for _ in used]
    for i in range(model.num_layers):
        c = layer_cont[i]
        slots.append(len(members[c]))
        members[c].append(i)

    def gather(arr_by_bit, c):
        return torch.stack([arr_by_bit[sel[i]][i] for i in members[c]])

    sites: Dict[str, Tuple[StackedQuant, ...]] = {}
    for name, stacks in model.sites.items():
        merged = []
        for c in range(len(used)):
            s0 = stacks[[b for b in range(len(stacks))
                         if remap.get(cont_of_bit[b]) == c][0]]
            merged.append(StackedQuant(
                packed=gather([s.packed for s in stacks], c),
                scale=gather([s.scale for s in stacks], c),
                zero=gather([s.zero for s in stacks], c),
                nbits=s0.nbits, group_size=s0.group_size, shape=s0.shape,
                superblock=s0.superblock))
        sites[name] = tuple(merged)
    return dataclasses.replace(
        model, sites=sites,
        select={name: list(layer_cont) for name in model.select},
        bits_range=tuple(containers[c] for c in used), slots=slots,
        uniform_select=True)


def set_arch(model: StackedModel, arch: Dict) -> StackedModel:
    """The same stacks with the selectors of ``arch`` (a new model object;
    no tensor is copied)."""
    if model.slots is not None:
        raise ValueError("a container-merged model is arch-specific; rebuild "
                         "it with stack_proxies + merge_containers")
    if "self_attn.qkv_proj" in model.sites and not _arch_fusable(
            arch, model.num_layers):
        raise ValueError("the arch mixes bits inside a fused q/k/v or gate/up "
                         "group; rebuild with stack_proxies(..., fuse='never')")
    rep = {**FUSED_GROUPS, **{n: (n,) for n in LINEAR_NAMES}}
    select = {name: [model.bits_range.index(int(b))
                     for b in arch["linear"][rep[name][0]]]
              for name in model.sites}
    if model.uniform_select and not _selectors_uniform(select):
        raise ValueError("the arch mixes bits across the sites of a layer of "
                         "a layer-uniform model; rebuild it per site")
    return dataclasses.replace(model, select=select)


def _stack_index(model: StackedModel, i: int) -> int:
    """Index of layer ``i`` inside the per-bit stacks: the layer number, or
    its compact-container slot for merged models."""
    return i if model.slots is None else model.slots[i]


def _apply_stack(stack: StackedQuant, i: int, x: torch.Tensor, compute_dtype):
    """Apply layer ``i`` of one bit-stack."""
    impl = linear_mod._KERNEL_IMPL
    if impl is not None and stack.superblock:
        from ..ops.quant_matmul import quant_matmul_indexed
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if x2.shape[0] >= _PREFILL_XLA_M:
            wt = linear_mod.dequantize_weight(stack.layer(i), compute_dtype)
            return linear_mod.matmul_f32(x, wt, None, compute_dtype)
        out = quant_matmul_indexed(
            x2, stack.packed, stack.scale, stack.zero, i, nbits=stack.nbits,
            group_size=stack.group_size, shape=stack.shape,
            superblock=stack.superblock, out_dtype=compute_dtype)
        return out.reshape(*lead, stack.shape[0])
    ql = linear_mod.QuantLinear(qt=stack.layer(i), bias=None)
    if impl is not None:
        return impl(ql, x, compute_dtype)
    return linear_mod.apply_linear(ql, x, compute_dtype)


def _add_bias(model: StackedModel, name: str, i: int, y: torch.Tensor):
    b = model.biases[name]
    return y if b is None else y + b[i].to(y.dtype)


def _apply_down_swiglu(model: StackedModel, i: int, gate, up, compute_dtype,
                       bit_idx: Optional[int] = None,
                       name: str = "mlp.down_proj"):
    """down-proj consuming (gate, up), with silu*mul fused into the
    kernel's prologue while the kernels are active."""
    stack = model.sites[name][model.select[name][i] if bit_idx is None
                              else bit_idx]
    si = _stack_index(model, i)
    rows = gate.numel() // gate.shape[-1]
    if (linear_mod.kernels_active() and stack.superblock
            and rows < _PREFILL_XLA_M):
        from ..ops.quant_matmul import quant_matmul_swiglu_indexed
        lead = gate.shape[:-1]
        y = quant_matmul_swiglu_indexed(
            gate.reshape(rows, -1), up.reshape(rows, -1), stack.packed,
            stack.scale, stack.zero, si, nbits=stack.nbits,
            group_size=stack.group_size, shape=stack.shape,
            superblock=stack.superblock, out_dtype=compute_dtype)
        y = y.reshape(*lead, stack.shape[0])
    else:
        act = F.silu(gate.float()).to(compute_dtype) * up
        y = _apply_stack(stack, si, act, compute_dtype)
    return _add_bias(model, name, i, y)


def _apply_site(model: StackedModel, name: str, i: int, x, compute_dtype,
                bit_idx: Optional[int] = None):
    """One linear site of layer ``i`` (``bit_idx`` hoisted by the caller
    for a layer-uniform model, else this site's selector)."""
    stack = model.sites[name][model.select[name][i] if bit_idx is None
                              else bit_idx]
    y = _apply_stack(stack, _stack_index(model, i), x, compute_dtype)
    return _add_bias(model, name, i, y)


def _apply_mlp_merged(model: StackedModel, i: int, h: torch.Tensor,
                      compute_dtype, bit_idx: Optional[int]):
    """The layer's whole MLP, ``down(swiglu(gateup(h)))``, in one launch
    (``ops.quant_matmul.quant_matmul_mlp_indexed``) when it applies;
    ``None`` otherwise (the caller takes the separate kernels).

    The JAX package's opt-in switch, read per call: ``AMQ_MLP_KERNEL=1``.
    It applies at decode shapes (M <= 8 rows) in bf16 with the kernels
    active on a CUDA tensor (``None`` on the CPU, as the JAX package on
    its CPU backend), a hoisted ``bit_idx`` (layer-uniform model), fused
    gateup and down sites of equal width, group and superblock, and no MLP
    biases.  The JAX package's TPU layout limits (intermediate width a
    multiple of 128, its scratch covering down's padded K, at least 8
    groups per superblock) do not bind the CUDA kernel; its own,
    ``ops.quant_matmul._mlp_applies`` (layers the grouped ring takes),
    take their place.
    """
    if bit_idx is None or compute_dtype != torch.bfloat16:
        return None
    if not linear_mod.kernels_active() or h.device.type == "cpu":
        return None
    if not _mlp_kernel_on():
        return None
    if "mlp.gateup_proj" not in model.sites or "mlp.down_proj" not in model.sites:
        return None
    if (model.biases["mlp.gateup_proj"] is not None
            or model.biases["mlp.down_proj"] is not None):
        return None
    gu = model.sites["mlp.gateup_proj"][bit_idx]
    dn = model.sites["mlp.down_proj"][bit_idx]
    if not (gu.superblock and dn.superblock):
        return None
    if (gu.nbits, gu.group_size, gu.superblock) != (dn.nbits, dn.group_size,
                                                     dn.superblock):
        return None
    lead = h.shape[:-1]
    M = h.numel() // h.shape[-1]
    if M > 8:
        return None
    from ..ops.quant_matmul import _mlp_applies, quant_matmul_mlp_indexed
    x = h.reshape(M, h.shape[-1]).contiguous()
    j = _stack_index(model, i)
    if not _mlp_applies(x, (gu.packed[j], gu.scale[j], gu.zero[j]),
                        (dn.packed[j], dn.scale[j], dn.zero[j]), gu.nbits,
                        gu.group_size, gu.superblock):
        return None
    out = quant_matmul_mlp_indexed(
        x, gu.packed, gu.scale, gu.zero, dn.packed, dn.scale, dn.zero, j,
        nbits=gu.nbits, group_size=gu.group_size, gu_shape=gu.shape,
        d_shape=dn.shape, superblock=gu.superblock, out_dtype=compute_dtype)
    return out.reshape(*lead, dn.shape[0])


def _moe_mlp(model: StackedModel, cfg: ModelConfig, i: int, h: torch.Tensor,
             compute_dtype, bit_idx: Optional[int]) -> torch.Tensor:
    """Layer ``i``'s sparse MLP (``Qwen2MoeSparseMoeBlock``): the float32
    router's top ``k`` experts per row, each pair's SwiGLU expert, their
    probability-weighted sum (``ops.moe``), plus the shared expert (the
    dense sites' kernels) scaled by sigmoid of its gate.  Spans
    ``moe.route``, ``moe.experts`` and ``moe.shared`` and the counter
    ``moe.pairs`` (rows x k) record in eager calls while a profiler runs;
    a captured graph's kernels are the trace's to sort by name.  Without
    the kernels (``use_kernels=False``) the experts and the combine take
    their plain versions, as the dense linears do."""
    from ..ops import moe
    lead, H = h.shape[:-1], h.shape[-1]
    x = h.reshape(-1, H)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    with TRACER.span("moe.route"):
        weights, ids = moe.route(x, model.router[i], k, cfg.norm_topk_prob)
    TRACER.count("moe.pairs", x.shape[0] * k)
    b = (model.select["mlp.experts.gateup_proj"][i] if bit_idx is None
         else bit_idx)
    gu = model.experts["mlp.experts.gateup_proj"][b]
    dn = model.experts["mlp.experts.down_proj"][b]
    kernels = linear_mod.kernels_active()
    args = (x, ids, gu.packed, gu.scale, gu.zero, dn.packed, dn.scale,
            dn.zero, _stack_index(model, i) * E)
    static = dict(num_experts=E, nbits=gu.nbits, group_size=gu.group_size,
                  gu_superblock=gu.superblock, dn_superblock=dn.superblock,
                  out_dtype=compute_dtype)
    with TRACER.span("moe.experts"):
        y = (moe.moe_experts(*args, layer=i, **static) if kernels
             else moe.experts_plain(*args, **static))
    with TRACER.span("moe.shared"):
        si = cfg.shared_expert_intermediate_size
        gus = _apply_site(model, "mlp.shared_expert.gateup_proj", i, h,
                          compute_dtype, bit_idx)
        shared = _apply_down_swiglu(model, i, gus[..., :si], gus[..., si:],
                                    compute_dtype, bit_idx,
                                    name="mlp.shared_expert.down_proj")
        logit = torch.matmul(x.float(), model.shared_gate[i].float())
    out = (moe.moe_combine if kernels else moe.combine_plain)(
        y, weights, shared.reshape(-1, H), logit, out_dtype=compute_dtype)
    return out.reshape(*lead, H)


@contextlib.contextmanager
def decode_switches(pipe: bool, mlp: bool):
    """The JAX package's two opt-in decode switches, set in-process.
    ``pipe`` is ``AMQ_PIPE`` (read at import into
    ``ops.quant_matmul._PIPE_DEFAULT``: the pipelined decode GEMVs), ``mlp``
    is ``AMQ_MLP_KERNEL`` (read per call by :func:`_apply_mlp_merged`: the
    one-launch decode MLP).  Both are restored on exit."""
    from ..ops import quant_matmul as qm
    old_pipe, old_mlp = qm._PIPE_DEFAULT, os.environ.get("AMQ_MLP_KERNEL")
    qm._PIPE_DEFAULT = int(pipe)
    os.environ["AMQ_MLP_KERNEL"] = "1" if mlp else "0"
    try:
        yield
    finally:
        qm._PIPE_DEFAULT = old_pipe
        if old_mlp is None:
            os.environ.pop("AMQ_MLP_KERNEL", None)
        else:
            os.environ["AMQ_MLP_KERNEL"] = old_mlp


def _mlp_kernel_on() -> bool:
    return os.environ.get("AMQ_MLP_KERNEL", "0") == "1"


def routing_key() -> Tuple[int, bool]:
    """The two decode switches as the wrappers read them now (``AMQ_PIPE``,
    ``AMQ_MLP_KERNEL``): what a captured step's route depends on beyond
    its shapes and dtypes, so ``serving.graphs`` keys its graphs on it."""
    from ..ops import quant_matmul as qm
    return int(qm._PIPE_DEFAULT), _mlp_kernel_on()


def scan_layers(model: StackedModel, cfg: ModelConfig, x: torch.Tensor,
                cache_kv=None, offset: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16, start_layer: int = 0,
                stop_layer: Optional[int] = None, tp_group=None):
    """The decoder-layer loop (no embed / final norm / head).

    ``offset`` is the cache length: a 0-d tensor, or one per row ``[B]``
    (slot-batched decode, S = 1: rope positions and attention per row).

    Returns ``(x, (k_app, v_app) or None)``: this step's keys and values
    ``[L, B, kv, S, hd]`` in the cache dtype.  The cache is read-only in
    here; the caller appends them once after all layers.

    Only layers ``[start_layer, stop_layer)`` run (no-cache path only): the
    sensitivity stage resumes a probe from the baseline's cached input of
    its first differing block.

    ``tp_group``: the model is one rank's tensor-parallel shard
    (``parallel.tp_stacked``, ``cfg`` its local config); the o output and
    the MLP output, whichever route computed it (the one-launch MLP or
    gateup -> SwiGLU-down), are summed over the group in place.
    """
    stop_layer = model.num_layers if stop_layer is None else stop_layer
    if cache_kv is not None and (start_layer,
                                 stop_layer) != (0, model.num_layers):
        raise ValueError("layer bounds apply to the no-cache path only")
    B, S, _ = x.shape
    hd = cfg.head_dim_
    if offset is None:
        offset = torch.zeros((), dtype=torch.int32, device=x.device)
    has_cache = cache_kv is not None
    T = cache_kv[0].shape[3] if has_cache else S
    positions = (torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                 + offset.reshape(-1, 1))
    cos, sin = llama.rope_cos_sin(cfg, positions, dtype=compute_dtype)
    mask = None if has_cache else llama._causal_mask(S, T, offset,
                                                     cfg.sliding_window)
    fused = "self_attn.qkv_proj" in model.sites
    first_site = next(iter(model.select))
    use_attn_kernel = (has_cache and S == 1 and hd in (64, 128)
                       and linear_mod.kernels_active())
    if use_attn_kernel:
        from ..ops.decode_attention import decode_attention_indexed
        offs = offset.to(torch.int32).reshape(-1).expand(B).contiguous()
    Hkv = cfg.num_kv_heads
    k_app, v_app = [], []

    for i in range(start_layer, stop_layer):
        bit_idx = model.select[first_site][i] if model.uniform_select else None
        h = llama.rms_norm(x, model.input_norm[i], cfg.rms_norm_eps)
        if fused:
            qkv = _apply_site(model, "self_attn.qkv_proj", i, h,
                              compute_dtype, bit_idx)
            # q and k heads are adjacent in qkv: one rope pass for both
            qk = llama.apply_rope(
                qkv[..., :cfg.q_dim + cfg.kv_dim].reshape(
                    B, S, cfg.num_heads + Hkv, hd), cos, sin)
            q, k = qk[:, :, :cfg.num_heads], qk[:, :, cfg.num_heads:]
            v = qkv[..., cfg.q_dim + cfg.kv_dim:]
        else:
            q = _apply_site(model, "self_attn.q_proj", i, h, compute_dtype,
                            bit_idx)
            k = _apply_site(model, "self_attn.k_proj", i, h, compute_dtype,
                            bit_idx)
            v = _apply_site(model, "self_attn.v_proj", i, h, compute_dtype,
                            bit_idx)
            q = llama.apply_rope(q.reshape(B, S, cfg.num_heads, hd), cos, sin)
            k = llama.apply_rope(k.reshape(B, S, Hkv, hd), cos, sin)
        k = k.transpose(1, 2)                       # [B, Hkv, S, hd]
        v = v.reshape(B, S, Hkv, hd).transpose(1, 2)

        if use_attn_kernel:
            G = cfg.num_heads // Hkv
            att = decode_attention_indexed(
                q.reshape(B, Hkv, G, hd).contiguous(), cache_kv[0],
                cache_kv[1], k.reshape(B, Hkv, hd).contiguous(),
                v.reshape(B, Hkv, hd).contiguous(), offs, i,
                window=cfg.sliding_window, out_dtype=compute_dtype)
        elif has_cache:
            att = llama.attention_append(q, cache_kv[0][i], cache_kv[1][i],
                                         k, v, offset, S, T, cfg,
                                         compute_dtype)
        else:
            att = llama.attention(q, k, v, mask, offset, S, S, cfg,
                                  compute_dtype)
        att = att.reshape(B, S, cfg.num_heads * hd)
        o = _apply_site(model, "self_attn.o_proj", i, att, compute_dtype,
                        bit_idx)
        if tp_group is not None:
            comm.all_reduce_(o, tp_group)
        x = x + o

        h = llama.rms_norm(x, model.post_norm[i], cfg.rms_norm_eps)
        if cfg.is_moe:
            down = _moe_mlp(model, cfg, i, h, compute_dtype, bit_idx)
        else:
            down = (_apply_mlp_merged(model, i, h, compute_dtype, bit_idx)
                    if fused else None)
        if down is None:
            if fused:
                gu = _apply_site(model, "mlp.gateup_proj", i, h,
                                 compute_dtype, bit_idx)
                gate = gu[..., :cfg.intermediate_size]
                up = gu[..., cfg.intermediate_size:]
            else:
                gate = _apply_site(model, "mlp.gate_proj", i, h,
                                   compute_dtype, bit_idx)
                up = _apply_site(model, "mlp.up_proj", i, h, compute_dtype,
                                 bit_idx)
            down = _apply_down_swiglu(model, i, gate, up, compute_dtype,
                                      bit_idx)
        if tp_group is not None:
            comm.all_reduce_(down, tp_group)
        x = x + down
        if has_cache:
            cd = cache_kv[0].dtype
            k_app.append(k.to(cd))
            v_app.append(v.to(cd))
    if has_cache:
        return x, (torch.stack(k_app), torch.stack(v_app))
    return x, None


def forward_stacked_suffix(model: StackedModel, cfg: ModelConfig,
                           x: torch.Tensor, start_layer: int,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits [B, S, vocab] float32 from ``x`` [B, S, H], the residual
    stream entering block ``start_layer``: blocks below it are skipped.
    With ``x`` from a baseline model, the same numbers as
    :func:`forward_stacked` of an arch that differs from the baseline only
    at blocks >= ``start_layer``."""
    x, _ = scan_layers(model, cfg, x, compute_dtype=compute_dtype,
                       start_layer=start_layer)
    x = llama.rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return apply_head(model, x, compute_dtype).float()


def forward_stacked(model: StackedModel, cfg: ModelConfig,
                    tokens: torch.Tensor,
                    cache: Optional[llama.KVCache] = None,
                    compute_dtype=torch.bfloat16, tp_group=None):
    """Full forward -> (logits [B, S, vocab] float32, cache).

    With a cache, this step's keys and values are appended once, after
    all layers, in place into the cache's buffers (the returned cache
    shares them, with the length advanced by S).

    ``tp_group``: ``model`` is one rank's tensor-parallel shard and
    ``cfg`` its local config (``parallel.tp_stacked``); the layers sum
    their o and MLP outputs over the group, and a packed head, which a
    TP model holds vocab-sharded (``ceil(V / tp)`` lanes per rank), has
    its logits gathered from every rank (the JAX ``all_gather``).
    """
    B, S = tokens.shape
    x = model.embed[tokens].to(compute_dtype)
    offset = (cache.length if cache is not None
              else torch.zeros((), dtype=torch.int32, device=x.device))
    x, kv_app = scan_layers(
        model, cfg, x,
        cache_kv=(cache.k, cache.v) if cache is not None else None,
        offset=offset, compute_dtype=compute_dtype, tp_group=tp_group)
    x = llama.rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    logits = apply_head(model, x, compute_dtype)
    if (tp_group is not None and model.lm_head_qt is not None
            and dist.get_world_size(tp_group) > 1):
        v_loc = -(-cfg.vocab_size // dist.get_world_size(tp_group))
        parts = comm.all_gather(logits[..., :v_loc].contiguous(), tp_group)
        logits = torch.cat(parts, dim=-1)[..., :cfg.vocab_size]
    new_cache = None
    if cache is not None:
        pos = offset + torch.arange(S, device=x.device)
        cache.k.index_copy_(3, pos, kv_app[0])
        cache.v.index_copy_(3, pos, kv_app[1])
        new_cache = llama.KVCache(k=cache.k, v=cache.v,
                                  length=cache.length + S)
    return logits.float(), new_cache
