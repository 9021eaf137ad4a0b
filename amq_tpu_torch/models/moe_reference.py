"""The plain float32 forward of a Qwen2-MoE decoder (Qwen2-57B-A14B).

The published ``Qwen2MoeForCausalLM`` forward (HF transformers,
``modeling_qwen2_moe.py``; widths in the Qwen2 technical report,
arXiv:2407.10671, Table 1), every layer sparse:

    h = rmsnorm(x) * w_in;  q, k, v = h Wq^T + bq, h Wk^T + bk, h Wv^T + bv
    q, k = rope(q), rope(k)               (half rotation, rope_theta)
    x = x + softmax(q k^T / sqrt(d) + causal) v  Wo^T   (GQA)
    h = rmsnorm(x) * w_post
    p = softmax(h Wg^T)                   (float32, over the E experts)
    (w_k, e_k) = top_k(p)                 (renormalised only with
                                           norm_topk_prob; false here)
    routed = sum_k w_k * down_{e_k}(silu(gate_{e_k} h) * up_{e_k} h)
    shared = sigmoid(h . w_s) * down_s(silu(gate_s h) * up_s h)
    x = x + routed + shared
    logits = (rmsnorm(x) * w_final) Whead^T

One sequence, no cache, no batching, every product in float32 with TF32
off; it imports no kernel of the port.  The only departure from the
published model is its weights: the dense float32 layout of
``models.moe.init_moe_params`` (in the tests, the dequantized weights of
the packed model under test, ``models.moe.dequantized_params``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[S, heads, d]`` rotated at positions 0..S-1."""
    S, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos.to(x.device) + rot * sin.to(x.device)


def _attention(q, k, v):
    S, Hq, d = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(S, Hkv, Hq // Hkv, d)
    scores = torch.einsum("skgd,tkd->kgst", qg, k) / math.sqrt(d)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("kgst,tkd->skgd", scores.softmax(-1), v)
    return out.reshape(S, Hq * d)


def _swiglu(h, gate, up, down):
    return (F.silu(h @ gate.T) * (h @ up.T)) @ down.T


def moe_block(h: torch.Tensor, lay: Dict, cfg) -> torch.Tensor:
    """The sparse MLP's output ``[S, H]`` for normed states ``h``."""
    probs = torch.softmax(h @ lay["mlp.gate"].T, dim=-1)
    weights, experts = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    routed = torch.zeros_like(h)
    for e in range(cfg.num_experts):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if len(rows):
            y = _swiglu(h[rows], lay["mlp.experts.gate_proj"][e],
                        lay["mlp.experts.up_proj"][e],
                        lay["mlp.experts.down_proj"][e])
            routed.index_add_(0, rows, weights[rows, slot, None] * y)
    shared = _swiglu(h, lay["mlp.shared_expert.gate_proj"],
                     lay["mlp.shared_expert.up_proj"],
                     lay["mlp.shared_expert.down_proj"])
    gate = torch.sigmoid(h @ lay["mlp.shared_expert_gate"])[:, None]
    return routed + gate * shared


def forward(params: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``[S, V]`` of the 1-D token sequence ``tokens``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(params, cfg, tokens)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _forward(params, cfg, tokens):
    Hq, Hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    eps = cfg.rms_norm_eps
    x = params["embed"][tokens.long()].float()
    S = x.shape[0]
    for lay in params["layers"]:
        h = _rms(x, lay["input_norm"], eps)
        q, k, v = (h @ lay[f"self_attn.{n}_proj"].T
                   + lay[f"self_attn.{n}_proj.bias"] for n in "qkv")
        q = _rope(q.reshape(S, Hq, d), cfg.rope_theta)
        k = _rope(k.reshape(S, Hkv, d), cfg.rope_theta)
        att = _attention(q, k, v.reshape(S, Hkv, d))
        x = x + att @ lay["self_attn.o_proj"].T
        x = x + moe_block(_rms(x, lay["post_norm"], eps), lay, cfg)
    return _rms(x, params["final_norm"], eps) @ params["lm_head"].T
