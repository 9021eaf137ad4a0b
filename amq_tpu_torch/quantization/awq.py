"""AWQ: activation-aware scale and clip search at each linear's own bits.

The port of the JAX package's ``quantization/awq.py``:

* per block, capture each linear site's input activations,
* scale search: per scale group ``(prev op, linears, inspected module)``
  a 20-point grid over alpha, ``scales = mean|x| ** alpha`` normalised by
  ``sqrt(max * min)``; each candidate fake-quantizes the group's linears at
  their searched bits and is scored by the inspected module's output MSE,
* the Llama groups: input_norm -> q/k/v (attention inspected), v -> o only
  without GQA, post_norm -> gate/up (MLP inspected), up -> down,
* clip search: per-group min/max shrinks (20 steps, at most 0.5)
  minimising per-channel output MSE on a 512-token subsample; q/k skipped,
* scales and clips applied, then group-wise pseudo-quantization.

The hidden states run through the *original* weights.  The clip search
takes its per-group products as batched matrix products over row chunks
(the same sums, in another order).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.pseudo import pseudo_quantize
from ..models import llama, transform
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import DenseLinear
from . import calib
from .calib import StageClock, stage

N_GRID = 20
CLIP_N_GRID = 20
CLIP_MAX_SHRINK = 0.5
CLIP_N_SAMPLE_TOKEN = 512
#: output rows per clip-search chunk
CLIP_ROWS = 2048


def _scale_groups(cfg: ModelConfig) -> List[Dict]:
    groups = [
        {"prev": "input_norm", "linears": ["self_attn.q_proj",
                                           "self_attn.k_proj",
                                           "self_attn.v_proj"],
         "inp": "self_attn.q_proj", "inspect": "attn"},
    ]
    if cfg.q_dim == cfg.kv_dim:          # v/o shapes match
        groups.append({"prev": "self_attn.v_proj",
                       "linears": ["self_attn.o_proj"],
                       "inp": "self_attn.o_proj", "inspect": "linear"})
    groups += [
        {"prev": "post_norm", "linears": ["mlp.gate_proj", "mlp.up_proj"],
         "inp": "mlp.gate_proj", "inspect": "mlp"},
        {"prev": "mlp.up_proj", "linears": ["mlp.down_proj"],
         "inp": "mlp.down_proj", "inspect": "linear"},
    ]
    return groups


def _inspect_forward(kind: str, layer, cfg, x, cos, sin, mask,
                     compute_dtype):
    if kind == "attn":
        return llama.attn_block(layer, cfg, x, cos, sin, mask,
                                compute_dtype)[0]
    if kind == "mlp":
        return llama.mlp_block(layer, x, compute_dtype)[0]
    raise ValueError(kind)


def _search_scale_group(layer, cfg, group, input_feat, bits_by_site,
                        cos, sin, mask, group_size, compute_dtype):
    """Grid search over alpha; returns the scales ``[in]``."""
    x = input_feat[group["inp"]]
    x_max = torch.mean(torch.abs(x.reshape(-1, x.shape[-1]).float()), dim=0)

    if group["inspect"] == "linear":
        (name,) = group["linears"]

        def run(test_layer):
            return x.float() @ test_layer[name].weight.float().T
    else:
        def run(test_layer):
            return _inspect_forward(group["inspect"], test_layer, cfg, x,
                                    cos, sin, mask, compute_dtype)

    org_out = run(layer).float()
    best_err, best_scales = np.inf, None
    for g in range(N_GRID):
        ratio = g / N_GRID
        scales = torch.clamp(x_max ** ratio, min=1e-4)
        scales = scales / torch.sqrt(scales.max() * scales.min())
        test_layer = dict(layer)
        for name in group["linears"]:
            p = layer[name]
            w = pseudo_quantize(p.weight * scales[None, :],
                                n_bit=int(bits_by_site[name]),
                                group_size=group_size)
            test_layer[name] = DenseLinear(weight=w / scales[None, :],
                                           bias=p.bias)
        loss = float(torch.mean((org_out - run(test_layer).float()) ** 2))
        if loss < best_err:
            best_err, best_scales = loss, scales
    assert best_scales is not None
    return best_scales


def _apply_scales_to_layer(layer, group, scales):
    """Divide the previous op's output by ``scales`` and multiply the
    group's linears' inputs by them."""
    out = dict(layer)
    prev = group["prev"]
    if prev in ("input_norm", "post_norm"):
        out[prev] = layer[prev] / scales
    else:                           # a linear: divide its output rows
        p = layer[prev]
        out[prev] = DenseLinear(
            weight=p.weight / scales[:, None],
            bias=None if p.bias is None else p.bias / scales)
    for name in group["linears"]:
        p = out[name]
        out[name] = DenseLinear(weight=p.weight * scales[None, :],
                                bias=p.bias)
    return out


def _clip_search_single(w: torch.Tensor, feat: torch.Tensor, n_bit: int,
                        group_size: int):
    """The asymmetric clip search of one weight ``w [co, ci]`` on the
    subsampled features ``feat [n_token, ci]``; returns (max_val,
    min_val), each ``[co, n_group, 1]``."""
    co, ci = w.shape
    g = group_size if group_size > 0 else ci
    xg = feat.float().reshape(feat.shape[0], ci // g, g)
    maxs, mins = [], []
    for r in range(0, co, CLIP_ROWS):
        wg = w[r:r + CLIP_ROWS].float().reshape(-1, ci // g, g)
        org_out = torch.einsum("cgk,tgk->ctg", wg, xg)   # [co, n_tok, n_g]
        org_max = wg.amax(dim=-1, keepdim=True)
        org_min = wg.amin(dim=-1, keepdim=True)
        best_max, best_min = org_max, org_min
        min_err = torch.full_like(org_max, float("inf"))
        for i_s in range(int(CLIP_MAX_SHRINK * CLIP_N_GRID)):
            shrink = 1.0 - i_s / CLIP_N_GRID
            max_v = org_max * shrink
            min_v = org_min * shrink
            cur_w = torch.clamp(wg, min_v, max_v)
            q_w = pseudo_quantize(cur_w.reshape(-1, g), n_bit=n_bit,
                                  group_size=g).reshape(cur_w.shape)
            cur_out = torch.einsum("cgk,tgk->ctg", q_w, xg)
            err = torch.mean((cur_out - org_out) ** 2, dim=1)[..., None]
            take = err < min_err
            best_max = torch.where(take, max_v, best_max)
            best_min = torch.where(take, min_v, best_min)
            min_err = torch.where(take, err, min_err)
        maxs.append(best_max)
        mins.append(best_min)
    return torch.cat(maxs), torch.cat(mins)


def _subsample_tokens(feat: torch.Tensor) -> torch.Tensor:
    x = feat.reshape(-1, feat.shape[-1])
    stride = max(1, x.shape[0] // CLIP_N_SAMPLE_TOKEN)
    return x[::stride]


@torch.inference_mode()
def awq_quantize_model(params: Dict[str, Any], cfg: ModelConfig,
                       arch: transform.Arch, calib_tokens: np.ndarray,
                       group_size: int = 128, clip_asym: bool = True,
                       batch_size: int = 8, compute_dtype=torch.float32,
                       progress: bool = False,
                       clock: Optional[StageClock] = None) -> Dict[str, Any]:
    """The AWQ pipeline -> fake-quantized params."""
    assert clip_asym, "the symmetric clip path is not implemented"
    states, rope = calib.embed_batches(params, cfg, calib_tokens, batch_size,
                                       compute_dtype)
    cos, sin, mask = rope
    groups = _scale_groups(cfg)

    out_layers = []
    for li, layer in enumerate(params["layers"]):
        bits_by_site = {nm: int(round(arch["linear"][nm][li]))
                        for nm in LINEAR_NAMES}
        # capture features and propagate with the ORIGINAL weights
        with stage(clock, "calibration"):
            feats = {nm: [] for nm in LINEAR_NAMES}
            next_states = []
            for x in states:
                h, caps = calib.run_block(layer, cfg, x, cos, sin, mask,
                                          capture=True,
                                          compute_dtype=compute_dtype)
                next_states.append(h)
                for nm in LINEAR_NAMES:
                    feats[nm].append(caps[nm])
            states = next_states
            feats = {nm: torch.cat(v, dim=0) for nm, v in feats.items()}

        with stage(clock, "quantization"):
            # every group searches the ORIGINAL layer; the scales are
            # applied afterwards
            group_scales = [
                _search_scale_group(layer, cfg, group, feats, bits_by_site,
                                    cos, sin, mask, group_size, compute_dtype)
                for group in groups]
            scaled_layer = dict(layer)
            for group, scales in zip(groups, group_scales):
                scaled_layer = _apply_scales_to_layer(scaled_layer, group,
                                                      scales)
                for nm in group["linears"]:
                    feats[nm] = feats[nm] / scales

            # clip search on the scaled weights (q/k skipped)
            for nm in LINEAR_NAMES:
                if "q_proj" in nm or "k_proj" in nm:
                    continue
                p = scaled_layer[nm]
                max_v, min_v = _clip_search_single(
                    p.weight, _subsample_tokens(feats[nm]),
                    n_bit=bits_by_site[nm], group_size=group_size)
                co, ci = p.weight.shape
                g = group_size if group_size > 0 else ci
                w = p.weight.reshape(co, ci // g, g)
                w = torch.clamp(w, min_v, max_v).reshape(co, ci)
                scaled_layer[nm] = DenseLinear(weight=w, bias=p.bias)

            # group-wise fake-quant at the arch's bits
            for nm in LINEAR_NAMES:
                p = scaled_layer[nm]
                w = pseudo_quantize(p.weight, n_bit=bits_by_site[nm],
                                    group_size=group_size)
                scaled_layer[nm] = DenseLinear(weight=w, bias=p.bias)
        del feats
        out_layers.append(scaled_layer)
        if progress:
            print(f"awq block {li} done", flush=True)

    out = dict(params)
    out["layers"] = out_layers
    return out
