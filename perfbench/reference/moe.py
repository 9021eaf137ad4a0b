"""Plain float32 forward of a Qwen2-MoE decoder (Qwen2-57B-A14B) over
packed weights, and the logit gaps that judge served tokens.

The layer equations (the published ``Qwen2MoeForCausalLM`` forward, every
layer sparse):

    h = rmsnorm(x) * w_in;  q, k, v = h Wq + bq, h Wk + bk, h Wv + bv
    q, k = rope(q), rope(k);  x = x + softmax(q k^T / sqrt(d) + causal) v Wo
    h = rmsnorm(x) * w_post;  p = softmax(h Wg^T)   (float32, E experts)
    (w_j, e_j) = top_k(p)     (not renormalised: norm_topk_prob false)
    x = x + sum_j w_j * down_{e_j}(silu(gate_{e_j} h) * up_{e_j} h)
          + sigmoid(h . w_s) * down_s(silu(gate_s h) * up_s h)
    logits = rmsnorm(x) * w_final  Whead

Weights are the benchmark's packed ``[K, N]`` words, dequantized by
``perfbench.reference.llama``'s frozen unpacking; fused sites keep the
column order q | k | v, gate | up.  Layer by layer over all sequences:
attention per sequence, the sparse block on the rows of all of them at
once, each expert dequantized once and only when some row chose it, so
the check holds one layer's dense sites and one expert in float32 at a
time beside the packed model.  It imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.llama import (_NoTF32, _attention, _rms, _rope,
                                       control_tokens, dequantize, fp8_mm,
                                       plain_mm, served_gaps)


def _attention_part(x, W, bias, shape, in_norm, mm):
    H = shape["hidden_size"]
    Hq, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    d = shape.get("head_dim") or H // Hq
    S = x.shape[0]
    h = _rms(x, in_norm, shape["rms_norm_eps"])
    qkv = mm(h, W["qkv"])
    if bias is not None:
        qkv = qkv + bias.float()
    theta = shape["rope_theta"]
    q = _rope(qkv[:, :Hq * d].reshape(S, Hq, d), theta)
    k = _rope(qkv[:, Hq * d:(Hq + Hkv) * d].reshape(S, Hkv, d), theta)
    v = qkv[:, (Hq + Hkv) * d:].reshape(S, Hkv, d)
    return x + mm(_attention(q, k, v), W["o"])


def _sparse_block(h, weights, i, shape, mm):
    """The sparse MLP's output for the normed rows ``h`` of layer ``i``."""
    E, k = shape["num_experts"], shape["num_experts_per_tok"]
    probs = torch.softmax(mm(h, weights.router[i].float().T), dim=-1)
    top, chosen = torch.topk(probs, k, dim=-1)
    if shape["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    ex = weights.experts[i]
    for e in range(E):
        rows, slot = torch.nonzero(chosen == e, as_tuple=True)
        if not len(rows):
            continue
        gu = mm(h[rows], dequantize(_Expert(ex["gateup"], e)))
        n = gu.shape[1] // 2
        y = mm(F.silu(gu[:, :n]) * gu[:, n:], dequantize(_Expert(ex["down"], e)))
        out.index_add_(0, rows, top[rows, slot, None] * y)
    lay = weights.layers[i]
    gu = mm(h, dequantize(lay["shared_gateup"]))
    n = gu.shape[1] // 2
    shared = mm(F.silu(gu[:, :n]) * gu[:, n:], dequantize(lay["shared_down"]))
    gate = torch.sigmoid(mm(h, weights.shared_gate[i].float()[:, None]))
    return out + gate * shared


class _Expert:
    """Expert ``e`` of a layer's packed expert stack, in ``dequantize``'s
    terms."""

    def __init__(self, p, e):
        self.packed, self.scale, self.zero = p.packed[e], p.scale[e], p.zero[e]
        self.nbits, self.group, self.superblock = p.nbits, p.group, p.superblock
        self.n, self.k = p.n, p.k


def logits_many(weights, shape: dict, seqs: Sequence[torch.Tensor],
                mm: Callable = plain_mm,
                first: Sequence[int] = ()) -> List[torch.Tensor]:
    """Float32 logits ``[S_i - first_i, V]`` of each 1-D token sequence
    under the packed ``weights`` (``perfbench.model_moe.MoeWeights``), from
    its row ``first_i`` on (0 when ``first`` is empty: a 152k vocabulary
    makes the prompt rows' logits the largest temporary); ``mm`` is every
    linear's product (``fp8_mm`` for the control)."""
    eps = shape["rms_norm_eps"]
    with _NoTF32(), torch.no_grad():
        xs = [weights.embed[s.long()].float() for s in seqs]
        lens = [len(s) for s in seqs]
        for i in range(len(weights.layers)):
            lay = weights.layers[i]
            W = {"qkv": dequantize(lay["qkv"]), "o": dequantize(lay["o"])}
            b = weights.bias.get("qkv")
            xs = [_attention_part(x, W, None if b is None else b[i], shape,
                                  weights.input_norm[i], mm) for x in xs]
            del W
            x = torch.cat(xs)
            h = _rms(x, weights.post_norm[i], eps)
            xs = list(torch.split(x + _sparse_block(h, weights, i, shape, mm),
                                  lens))
        head = dequantize(weights.head)
        first = list(first) or [0] * len(xs)
        return [mm(_rms(x[f:], weights.final_norm, eps), head)
                for x, f in zip(xs, first)]


def judge(weights, shape: dict, requests: Sequence[Dict],
          control: bool = False) -> Dict[str, float]:
    """Mean and widest gap of the served tokens of ``requests``
    (``prompt``, ``served``: 1-D int tensors) under the reference, and the
    number of tokens compared.  The mean is what judges a sparse model:
    the widest is set by one token whose k-th and (k+1)-th experts lie
    within a bf16 rounding of each other, where the float32 reference
    routes the other way (sound runs read 0.17-0.80 from seed to seed).
    With ``control`` the control (every linear, the router and the shared
    gate included, through ``fp8_mm``) stands in the program's place: the
    tokens it puts first on the same prompts and served tokens are
    judged."""
    seqs = [torch.cat([r["prompt"], r["served"]]) for r in requests]
    # logits from the row that predicts the first served token
    first = [len(r["prompt"]) - 1 for r in requests]
    ref = logits_many(weights, shape, seqs, first=first)
    if control:
        ctl = logits_many(weights, shape, seqs, fp8_mm, first=first)
        requests = [dict(r, served=control_tokens(c, 1, len(r["served"])))
                    for c, r in zip(ctl, requests)]
    gaps = [served_gaps(lg, 1, r["served"]) for lg, r in zip(ref, requests)]
    gaps = torch.cat(gaps)
    return {"mean_logit_gap": float(gaps.mean()),
            "logit_gap": float(gaps.max()), "tokens": len(gaps)}
