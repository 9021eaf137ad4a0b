"""Plain float32 forward of a Llama-family decoder (Mistral, Qwen2.5) over
packed weights, and the logit gaps that judge served tokens.

The layer equations (the published ``LlamaForCausalLM`` /
``MistralForCausalLM`` / ``Qwen2ForCausalLM`` forward):

    h = rmsnorm(x) * w_in;  q, k, v = h Wq (+bq), h Wk (+bk), h Wv (+bv)
    q, k = rope(q), rope(k)         (half rotation, theta from the config)
    x = x + softmax(q k^T / sqrt(d) + causal) v  Wo    (GQA: kv head j
                                                        serves q heads jG..)
    h = rmsnorm(x) * w_post;  x = x + (silu(h Wg) * h Wu) Wd
    logits = rmsnorm(x) * w_final  Whead

Weights are the benchmark's packed ``[K, N]`` words, dequantized here as
``(code - zero) * scale`` per group of K rows, with a frozen copy of the
pair-planar unpacking below.  The fused sites keep the reference's column
order: q | k | v, gate | up.  A layer's weights are dequantized once and
applied to every sequence before the next layer, so the check holds one
layer in float32 at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

#: 3/5/6-bit codes as a hi plane and a lo plane
_PLANES = {3: (2, 1), 5: (4, 1), 6: (4, 2)}


def _unpack_pow2(w: torch.Tensor, nbits: int, block: int) -> torch.Tensor:
    """``[G, R, N]`` int32 words -> ``[G, block, N]`` codes: block row
    ``p * 2R + 2r + h`` is word row r at bit ``16 h + nbits p``."""
    G, R, N = w.shape
    P = 16 // nbits
    out = torch.empty((G, P, R, 2, N), dtype=torch.int32, device=w.device)
    for p in range(P):
        for h in range(2):
            out[:, p, :, h] = (w >> (16 * h + nbits * p)) & ((1 << nbits) - 1)
    return out.reshape(G, block, N)


def unpack(words: torch.Tensor, nbits: int, block: int) -> torch.Tensor:
    """Codes ``[R * 32 / nbits, N]`` of int32 words ``[R, N]`` packed in
    blocks of ``block`` K rows."""
    rows = block * nbits // 32
    R, N = words.shape
    w = words.reshape(R // rows, rows, N)
    if nbits in _PLANES:
        hb, lb = _PLANES[nbits]
        hi_rows = block * hb // 32
        return ((_unpack_pow2(w[:, :hi_rows], hb, block) << lb)
                | _unpack_pow2(w[:, hi_rows:], lb, block)).reshape(-1, N)
    return _unpack_pow2(w, nbits, block).reshape(-1, N)


def dequantize(p) -> torch.Tensor:
    """The logical float32 weight ``[K, N]`` of a packed weight ``p``
    (``model.Packed`` or anything with its fields)."""
    codes = unpack(p.packed, p.nbits, p.superblock).float()
    Kp, Np = codes.shape
    g = p.group
    w = ((codes.reshape(Kp // g, g, Np) - p.zero.float()[:, None])
         * p.scale.float()[:, None]).reshape(Kp, Np)
    return w[:p.k, :p.n]


def plain_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax to 448), back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: activations per row and weights per output
    column rounded to float8 e4m3, the product in float32."""
    return _fp8(a, -1) @ _fp8(w, 0)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[S, heads, d]`` rotated at positions 0..S-1 (half rotation)."""
    S, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def _attention(q, k, v):
    """Causal GQA: q ``[S, Hq, d]``, k / v ``[S, Hkv, d]`` -> ``[S, Hq * d]``."""
    S, Hq, d = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(S, Hkv, Hq // Hkv, d)
    scores = torch.einsum("skgd,tkd->kgst", qg, k) / math.sqrt(d)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("kgst,tkd->skgd", scores.softmax(-1), v)
    return out.reshape(S, Hq * d)


def _layer(x, W, bias, shape, in_norm, post_norm, mm):
    H = shape["hidden_size"]
    Hq, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    d = shape.get("head_dim") or H // Hq
    eps, theta = shape["rms_norm_eps"], shape["rope_theta"]
    S = x.shape[0]
    h = _rms(x, in_norm, eps)
    qkv = mm(h, W["qkv"])
    if bias is not None:
        qkv = qkv + bias.float()
    q = _rope(qkv[:, :Hq * d].reshape(S, Hq, d), theta)
    k = _rope(qkv[:, Hq * d:(Hq + Hkv) * d].reshape(S, Hkv, d), theta)
    v = qkv[:, (Hq + Hkv) * d:].reshape(S, Hkv, d)
    x = x + mm(_attention(q, k, v), W["o"])
    h = _rms(x, post_norm, eps)
    gu = mm(h, W["gateup"])
    I = gu.shape[1] // 2
    return x + mm(F.silu(gu[:, :I]) * gu[:, I:], W["down"])


class Packed:
    """A served model's packed weights (``perfbench.model.Weights``), its
    fused sites dequantized here."""

    def __init__(self, weights):
        self.w = weights
        self.embed, self.final_norm = weights.embed, weights.final_norm
        self.n_layers = len(weights.layers)

    def layer(self, i):
        b = self.w.bias.get("qkv")
        return ({site: dequantize(p) for site, p in self.w.layers[i].items()},
                None if b is None else b[i], self.w.input_norm[i],
                self.w.post_norm[i])

    def head(self):
        return dequantize(self.w.head)


#: the reference's linear names, in q | k | v and gate | up order
NAMES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


class Dense:
    """Dense parameters in the ``init_params`` layout (per layer each name
    of :data:`NAMES` with ``.weight [out, in]`` and ``.bias``, the norms;
    ``embed``, ``final_norm``, ``lm_head.weight``).  ``linears(i)``, when
    given, replaces layer i's weights (``{name: [K, N] float32}``)."""

    def __init__(self, params, linears=None):
        self.p = params
        self.linears = linears
        self.embed, self.final_norm = params["embed"], params["final_norm"]
        self.n_layers = len(params["layers"])

    def layer(self, i):
        lay = self.p["layers"][i]
        w = (self.linears(i) if self.linears is not None else
             {n: lay[n].weight.float().T for n in NAMES})
        q, k, v, o, g, u, dn = (w[n] for n in NAMES)
        bias = [lay[n].bias for n in NAMES[:3]]
        b = None if bias[0] is None else torch.cat([t.float() for t in bias])
        return ({"qkv": torch.cat([q, k, v], 1), "o": o,
                 "gateup": torch.cat([g, u], 1), "down": dn},
                b, lay["input_norm"], lay["post_norm"])

    def head(self):
        return self.p["lm_head"].weight.float().T


class _NoTF32:
    """float32 products in float32 (TF32 off) inside the block."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False


def final_states(m, shape: dict, seqs: Sequence[torch.Tensor],
                 mm: Callable = plain_mm) -> List[torch.Tensor]:
    """Float32 final normed states ``[S_i, H]`` of each 1-D token sequence
    under model ``m`` (:class:`Packed`, :class:`Dense`), layer by layer
    over all sequences; ``mm`` is every linear's product (``fp8_mm`` for
    the control)."""
    with _NoTF32(), torch.no_grad():
        xs = [m.embed[s.long()].float() for s in seqs]
        for i in range(m.n_layers):
            W, b, n_in, n_post = m.layer(i)
            xs = [_layer(x, W, b, shape, n_in, n_post, mm) for x in xs]
            del W
        return [_rms(x, m.final_norm, shape["rms_norm_eps"]) for x in xs]


def logits(x: torch.Tensor, head: torch.Tensor,
           mm: Callable = plain_mm) -> torch.Tensor:
    """Float32 logits of final states ``x`` with the head ``[H, V]``."""
    with _NoTF32(), torch.no_grad():
        return mm(x, head)


def logits_many(weights, shape: dict, seqs: Sequence[torch.Tensor],
                mm: Callable = plain_mm) -> List[torch.Tensor]:
    """Float32 logits ``[S_i, V]`` of each sequence under a served model's
    packed ``weights``."""
    m = Packed(weights)
    head = m.head()
    return [logits(x, head, mm) for x in final_states(m, shape, seqs, mm)]


def served_gaps(logits: torch.Tensor, prompt_len: int,
                served: torch.Tensor) -> torch.Tensor:
    """Per served token, how far its logit lies below the best logit at the
    position that predicts it (``logits`` over prompt + served tokens)."""
    rows = logits[prompt_len - 1:prompt_len - 1 + len(served)]
    picked = rows.gather(1, served.long().view(-1, 1))[:, 0]
    return rows.max(1).values - picked


def control_tokens(ctl: torch.Tensor, prompt_len: int, n: int) -> torch.Tensor:
    """The tokens the control puts first at the ``n`` positions that
    predict the served tokens (``ctl``: the control's logits over prompt +
    served tokens)."""
    return ctl[prompt_len - 1:prompt_len - 1 + n].argmax(1)


def judge(weights, shape: dict, requests: Sequence[Dict],
          control: bool = False) -> Dict[str, float]:
    """Widest gap of the served tokens of ``requests`` (``prompt``,
    ``served``: 1-D int tensors) under the reference, and the number of
    tokens compared.  With ``control`` the control stands in the program's
    place: on the same prompts and served tokens, the tokens it puts first
    are judged instead of the served ones."""
    seqs = [torch.cat([r["prompt"], r["served"]]) for r in requests]
    ref = logits_many(weights, shape, seqs)
    if control:
        ctl = logits_many(weights, shape, seqs, fp8_mm)
        requests = [dict(r, served=control_tokens(c, len(r["prompt"]),
                                                  len(r["served"])))
                    for c, r in zip(ctl, requests)]
    gaps = [served_gaps(lg, len(r["prompt"]), r["served"])
            for lg, r in zip(ref, requests)]
    return {"logit_gap": float(torch.cat(gaps).max()),
            "tokens": int(sum(len(g) for g in gaps))}
