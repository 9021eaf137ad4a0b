"""Llama-family decoder (Llama-2/3/3.1, Mistral, Qwen2/2.5) in PyTorch.

The port of the JAX package's ``models/llama.py``: parameters are a plain
dict (``init_params`` layout), the forward is a function, and the KV cache
is an explicit :class:`KVCache` of ``[L, B, Hkv, T, hd]`` buffers.  One
implementation covers the family through ``ModelConfig`` flags (GQA,
qkv_bias, sliding window, Llama-3.1 rope scaling).

Attention layouts are the JAX ones (q ``[B, S, Hq, hd]``, cache
``[B, Hkv, T, hd]``) so that tests compare like with like.  Where the JAX
package takes its blockwise flash kernel (S >= 128, S % 64 == 0, no
sliding window in range, on its accelerator), :func:`attention` and
:func:`attention_append` launch the CUDA flash kernel
(``ops.flash_attention``) on a CUDA tensor; the CPU takes the einsum path,
as the JAX package does on its CPU backend.  :class:`forward_kernels`
turns it and the dequantization kernel off for a kernel-vs-plain
comparison on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel import comm
from . import linear as _linear
from .config import LINEAR_NAMES, ModelConfig
from .linear import DenseLinear, apply_linear, matmul_out_f32


# ---------------------------------------------------------------------------
# KV cache

@dataclasses.dataclass
class KVCache:
    """Preallocated K/V buffers ``[n_layers, B, n_kv, max_len, hd]`` and
    the live length as a 0-d int32 tensor on the cache's device (so a
    decode loop never reads it back to the host)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim_)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# building blocks

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in float32, rounded to x's dtype,
    times the weight (one fused kernel on CUDA, F.rms_norm)."""
    xf = torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return xf.to(x.dtype) * weight.to(x.dtype)


def _llama3_scale_freqs(freqs: torch.Tensor) -> torch.Tensor:
    """Llama-3.1 rope frequency rescaling (HF rope_scaling type='llama3')."""
    factor, low, high, orig = 8.0, 1.0, 4.0, 8192.0
    wavelen = 2.0 * math.pi / freqs
    low_wl = orig / low
    high_wl = orig / high
    smooth = (orig / wavelen - low) / (high - low)
    return torch.where(
        wavelen > low_wl, freqs / factor,
        torch.where(wavelen < high_wl, freqs,
                    (1 - smooth) * freqs / factor + smooth * freqs))


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., head_dim]`` (HF half-rotation convention)."""
    hd = cfg.head_dim_
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    theta = torch.full((), cfg.rope_theta, dtype=torch.float32,
                       device=positions.device)
    inv_freq = 1.0 / torch.pow(theta, exps)
    if cfg.rope_scaling_llama3:
        inv_freq = _llama3_scale_freqs(inv_freq)
    angles = positions[..., None].float() * inv_freq              # [..., hd/2]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B?, S, hd] -> broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[..., None, :] if cos.dim() == x.dim() - 1 else cos
    s = sin[..., None, :] if sin.dim() == x.dim() - 1 else sin
    return (x * c + rotated * s).to(x.dtype)


def _attention(q, k, v, mask, compute_dtype):
    """q: [B,S,Hq,hd], k/v: [B,Hkv,T,hd], mask: [B?,1,S,T] additive.

    GQA is a grouped einsum over [Hkv, G]; K/V are never repeated to Hq.
    Products are taken in float32; the probabilities are rounded to the
    cache dtype before the PV product, as the accelerator path does.
    """
    B, S, Hq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).float()
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k.float())
    scores = scores / math.sqrt(hd) + mask[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(k.dtype).float()
    out = torch.einsum("bkgst,bktd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, hd).to(compute_dtype)


def _attention_split(q, k_c, v_c, k_new, v_new, offset,
                     sliding_window, compute_dtype):
    """Incremental attention without materializing the updated cache.

    q: [B,S,Hq,hd]; k_c/v_c: [B,Hkv,T,hd] cache buffers (positions
    ``< offset`` valid); k_new/v_new: [B,Hkv,S,hd] this step's keys.
    ``offset`` is a 0-d or per-row ``[B]`` int tensor.  Scores over the
    cache and over the new keys are softmaxed jointly.
    """
    B, S, Hq, hd = q.shape
    Hkv = k_c.shape[1]
    G = Hq // Hkv
    T = k_c.shape[2]
    dev = q.device
    qg = q.reshape(B, S, Hkv, G, hd).float()
    sc = torch.einsum("bskgd,bktd->bkgst", qg, k_c.float())
    sn = torch.einsum("bskgd,bkud->bkgsu", qg, k_new.float())
    inv = 1.0 / math.sqrt(hd)

    off = torch.as_tensor(offset, device=dev).to(torch.int32).reshape(-1)
    s_ids = torch.arange(S, dtype=torch.int32, device=dev)
    k_pos = torch.arange(T, dtype=torch.int32, device=dev)
    q_pos = off[:, None] + s_ids[None, :]                          # [b, S]
    ok_c = k_pos[None, None, :] < off[:, None, None]               # [b, 1, T]
    ok_n = s_ids[None, None, :] <= s_ids[None, :, None]            # [1, S, S]
    if sliding_window is not None:
        ok_c = ok_c & (k_pos[None, None, :] > q_pos[:, :, None] - sliding_window)
        ok_n = ok_n & ((off[:, None, None] + s_ids[None, None, :])
                       > q_pos[:, :, None] - sliding_window)
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mask_c = torch.where(ok_c, zero, neg)[:, None, None]      # [b,1,1,S|1,T]
    mask_n = torch.where(ok_n, zero, neg)[:, None, None]
    scores = torch.cat([sc * inv + mask_c, sn * inv + mask_n], dim=-1)
    probs = torch.softmax(scores, dim=-1).to(k_c.dtype).float()
    out = (torch.einsum("bkgst,bktd->bskgd", probs[..., :T], v_c.float())
           + torch.einsum("bkgsu,bkud->bskgd", probs[..., T:],
                          v_new.to(v_c.dtype).float()))
    return out.reshape(B, S, Hq, hd).to(compute_dtype)


#: False inside ``forward_kernels(False)``
_FLASH_KERNEL = True


class forward_kernels:
    """Context manager: ``forward_kernels(False)`` sends attention that
    would take the flash kernel through the einsum path, and the
    dequantize-then-matmul linears through the plain dequantization (the
    plain side of a kernel-vs-plain comparison on the card)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __enter__(self):
        global _FLASH_KERNEL
        self._old = _FLASH_KERNEL, _linear._DEQUANT_KERNEL
        _FLASH_KERNEL = _linear._DEQUANT_KERNEL = self.enabled
        return self

    def __exit__(self, *exc):
        global _FLASH_KERNEL
        _FLASH_KERNEL, _linear._DEQUANT_KERNEL = self._old
        return False


def _flash_ok(S: int, T: int, cfg: ModelConfig, device) -> bool:
    """Take the flash kernel?  The JAX package's rule (long enough S, pure
    causal(+offset) masking) on a CUDA tensor, unless turned off."""
    if S < 128 or S % 64:
        return False
    if cfg.sliding_window is not None and T > cfg.sliding_window:
        return False
    return torch.device(device).type == "cuda" and _FLASH_KERNEL


def _flash(q, k, v, offset, compute_dtype):
    """q [B,S,Hq,hd], k/v [B,Hkv,T,hd] (compute dtype) -> [B,S,Hq,hd]."""
    from ..ops.flash_attention import flash_attention
    out = flash_attention(q.transpose(1, 2).contiguous(), k.contiguous(),
                          v.contiguous(), offset)
    return out.transpose(1, 2).to(compute_dtype)


def attention_append(q, k_c, v_c, k_new, v_new, offset, S: int, T: int,
                     cfg: ModelConfig, compute_dtype):
    """Cache attention against (cache, appended keys).

    In the flash regime the new keys go into a local copy of the buffer
    (its cost amortizes over S tokens; the cache itself stays read-only)
    and the kernel attends over it from ``offset``; elsewhere the split
    path avoids the copy."""
    if _flash_ok(S, T, cfg, q.device):
        pos = offset + torch.arange(S, device=q.device)
        k_buf = k_c.index_copy(2, pos, k_new.to(k_c.dtype))
        v_buf = v_c.index_copy(2, pos, v_new.to(v_c.dtype))
        return _flash(q, k_buf.to(compute_dtype), v_buf.to(compute_dtype),
                      offset, compute_dtype)
    return _attention_split(q, k_c, v_c, k_new, v_new, offset,
                            cfg.sliding_window, compute_dtype)


def attention(q, k, v, mask, offset, S: int, T: int, cfg: ModelConfig,
              compute_dtype):
    """q: [B,S,Hq,hd]; k/v: [B,Hkv,T,hd]; returns [B,S,Hq,hd]."""
    if _flash_ok(S, T, cfg, q.device):
        return _flash(q, k, v, offset, compute_dtype)
    return _attention(q, k, v, mask, compute_dtype)


def _causal_mask(S: int, T: int, offset: torch.Tensor,
                 sliding_window: Optional[int]) -> torch.Tensor:
    """Additive mask [1,1,S,T]; query i attends keys j with j <= i+offset."""
    dev = offset.device
    q_pos = torch.arange(S, dtype=torch.int32, device=dev)[:, None] + offset
    k_pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    ok = k_pos <= q_pos
    if sliding_window is not None:
        ok = ok & (k_pos > q_pos - sliding_window)
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(ok, zero, neg)[None, None]


# ---------------------------------------------------------------------------
# forward

def attn_block(layer, cfg, h, cos, sin, mask, compute_dtype, cache=None,
               idx=0, offset=None):
    """Attention sub-block on the normed input ``h``; returns (o_proj
    output, o_proj input).  Without a cache it attends over ``h``'s own
    keys from position 0."""
    B, S, _ = h.shape
    if offset is None:
        offset = torch.zeros((), dtype=torch.int32, device=h.device)
    hd = cfg.head_dim_
    q = apply_linear(layer["self_attn.q_proj"], h, compute_dtype)
    k = apply_linear(layer["self_attn.k_proj"], h, compute_dtype)
    v = apply_linear(layer["self_attn.v_proj"], h, compute_dtype)
    q = apply_rope(q.reshape(B, S, cfg.num_heads, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, cfg.num_kv_heads, hd), cos, sin)
    k = k.transpose(1, 2)                          # [B, Hkv, S, hd]
    v = v.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    if cache is not None:
        # in place: this layer's keys go into its cache slab, then the
        # query attends over the whole (masked) buffer
        pos = offset + torch.arange(S, device=h.device)
        cache.k[idx].index_copy_(2, pos, k.to(cache.k.dtype))
        cache.v[idx].index_copy_(2, pos, v.to(cache.v.dtype))
        k_att, v_att = cache.k[idx].to(compute_dtype), cache.v[idx].to(compute_dtype)
    else:
        k_att, v_att = k, v
    T = k_att.shape[2]
    att = attention(q, k_att, v_att, mask, offset, S, T, cfg, compute_dtype)
    att = att.reshape(B, S, cfg.num_heads * hd)
    return apply_linear(layer["self_attn.o_proj"], att, compute_dtype), att


def mlp_block(layer, h, compute_dtype):
    """SwiGLU MLP on the normed input; returns (output, down_proj input)."""
    gate = apply_linear(layer["mlp.gate_proj"], h, compute_dtype)
    up = apply_linear(layer["mlp.up_proj"], h, compute_dtype)
    act = torch.nn.functional.silu(gate.float()).to(compute_dtype) * up
    return apply_linear(layer["mlp.down_proj"], act, compute_dtype), act


def decoder_layer(layer: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                  cos, sin, mask, compute_dtype,
                  captures: Optional[Dict[str, torch.Tensor]] = None,
                  cache: Optional[KVCache] = None, idx: int = 0,
                  offset: Optional[torch.Tensor] = None,
                  tp_group=None) -> torch.Tensor:
    """One decoder block.  If ``captures`` is a dict it is filled with the
    input activations of each linear site (what GPTQ's Hessians and AWQ's
    feature caches read).  Attention routes as in :func:`forward`: flash
    at S >= 128 on the card.

    ``tp_group`` is Megatron-style tensor parallelism (``parallel.tp``):
    q/k/v/gate/up hold this rank's heads and intermediate slice, o/down
    its rows, and their partial outputs are summed over the group in
    place (the JAX ``psum`` over ``tp_axis``)."""
    h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
    if captures is not None:
        for name in ("self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj"):
            captures[name] = h
    att, att_in = attn_block(layer, cfg, h, cos, sin, mask, compute_dtype,
                             cache, idx, offset)
    if captures is not None:
        captures["self_attn.o_proj"] = att_in
    if tp_group is not None:
        comm.all_reduce_(att, tp_group)
    x = x + att
    h = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps)
    if captures is not None:
        captures["mlp.gate_proj"] = h
        captures["mlp.up_proj"] = h
    out, act = mlp_block(layer, h, compute_dtype)
    if captures is not None:
        captures["mlp.down_proj"] = act
    if tp_group is not None:
        comm.all_reduce_(out, tp_group)
    return x + out


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[KVCache] = None,
            compute_dtype=torch.float32,
            tp_group=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Layer-by-layer forward over ``init_params``-shaped parameters.

    Returns (logits [B, S, vocab] float32, cache).  With a cache, this
    step's keys are written into it in place and the returned cache
    shares its buffers, with the length advanced by S.  ``tp_group``: see
    :func:`decoder_layer` (``cfg`` is then the rank's local config).
    """
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    dev = x.device
    if cache is not None:
        offset = cache.length
        T = cache.k.shape[3]
    else:
        offset = torch.zeros((), dtype=torch.int32, device=dev)
        T = S
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :] + offset
    cos, sin = rope_cos_sin(cfg, positions, dtype=compute_dtype)
    mask = _causal_mask(S, T, offset, cfg.sliding_window)

    for idx, layer in enumerate(params["layers"]):
        x = decoder_layer(layer, cfg, x, cos, sin, mask, compute_dtype,
                          cache=cache, idx=idx, offset=offset,
                          tp_group=tp_group)

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:                       # tied embeddings
        logits = matmul_out_f32(x, params["embed"].T, compute_dtype)
    else:
        logits = apply_linear(head, x, compute_dtype).float()
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, length=cache.length + S)
    return logits.float(), new_cache


# ---------------------------------------------------------------------------
# parameter init

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Random params of the JAX ``init_params`` layout, drawn from
    ``generator`` on ``device`` (normal / sqrt(fan_in), unit norms, zero
    qkv biases).  Its numbers differ from the JAX ones for the same seed;
    tests carry JAX parameters across with ``models.convert`` instead."""
    h = cfg.hidden_size

    def dense(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(shape[-1]))).to(dtype)

    layers: List[Dict[str, Any]] = []
    for _ in range(cfg.num_layers):
        layer: Dict[str, Any] = {
            "input_norm": torch.ones((h,), dtype=dtype, device=device),
            "post_norm": torch.ones((h,), dtype=dtype, device=device),
        }
        for name in LINEAR_NAMES:
            out_f, in_f = cfg.linear_shape(name)
            bias = None
            if cfg.qkv_bias and name in ("self_attn.q_proj",
                                         "self_attn.k_proj",
                                         "self_attn.v_proj"):
                bias = torch.zeros((out_f,), dtype=dtype, device=device)
            layer[name] = DenseLinear(weight=dense((out_f, in_f)), bias=bias)
        layers.append(layer)
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab_size, h)),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = DenseLinear(weight=dense((cfg.vocab_size, h)))
    return params
