"""Block-wise calibration propagation.

The port of the JAX package's ``quantization/calib.py``: embed once, then
fold each decoder layer over the hidden states, optionally collecting each
linear site's input activations (``llama.decoder_layer``'s ``captures``).
:class:`StageClock` adds up the seconds of each realization stage.

Not ported: ``layer_to_host``, a 16 GB-chip memory mode (an 80 GB card
holds the dense bf16 7B model beside its fake-quantized copy).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import synchronize
from ..models import llama
from ..models.config import ModelConfig


class StageClock:
    """Seconds per named stage on ``device``'s clock: the card's queued
    work is waited for at each stage's start and end."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def stage(clock: Optional[StageClock], name: str):
    return clock(name) if clock is not None else contextlib.nullcontext()


def embed_inputs(params: Dict[str, Any], cfg: ModelConfig,
                 tokens: torch.Tensor, compute_dtype=torch.float32):
    """Token embedding and the shared rope / causal mask of a
    full-sequence pass."""
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = llama.rope_cos_sin(cfg, positions, dtype=compute_dtype)
    mask = llama._causal_mask(S, S, torch.zeros((), dtype=torch.int32,
                                                device=dev),
                              cfg.sliding_window)
    return x, cos, sin, mask


def embed_batches(params: Dict[str, Any], cfg: ModelConfig,
                  calib_tokens: np.ndarray, batch_size: int,
                  compute_dtype) -> Tuple[List[torch.Tensor], tuple]:
    """Embedded hidden states of each calibration batch, and the
    (cos, sin, mask) they share."""
    dev = params["embed"].device
    states, rope = [], None
    for i in range(0, calib_tokens.shape[0], batch_size):
        toks = torch.as_tensor(calib_tokens[i:i + batch_size],
                               dtype=torch.int64, device=dev)
        x, cos, sin, mask = embed_inputs(params, cfg, toks, compute_dtype)
        states.append(x)
        rope = (cos, sin, mask)
    return states, rope


@torch.inference_mode()
def run_block(layer_params, cfg: ModelConfig, x, cos, sin, mask,
              capture: bool = False, compute_dtype=torch.float32):
    """One decoder block; returns (out hidden, captures dict or {})."""
    caps: Optional[Dict[str, torch.Tensor]] = {} if capture else None
    out = llama.decoder_layer(layer_params, cfg, x, cos, sin, mask,
                              compute_dtype, captures=caps)
    return out, (caps or {})


@torch.inference_mode()
def accumulate_hessians(captures: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Per-site ``X^T X`` over all tokens (unnormalized, float32).  Sites
    that read the same activations (q/k/v, gate/up) share one product."""
    out: Dict[str, torch.Tensor] = {}
    done: Dict[int, torch.Tensor] = {}
    for name, x in captures.items():
        if id(x) not in done:
            xf = x.reshape(-1, x.shape[-1]).float()
            done[id(x)] = xf.T @ xf
        out[name] = done[id(x)]
    return out


def layer_hessians(layer, cfg: ModelConfig, states, rope, compute_dtype,
                   clock: Optional[StageClock] = None
                   ) -> Dict[str, torch.Tensor]:
    """Summed ``X^T X`` of every linear site of ``layer`` over the
    calibration batches ``states`` (one capturing forward per batch)."""
    cos, sin, mask = rope
    hessians: Dict[str, torch.Tensor] = {}
    for x in states:
        with stage(clock, "calibration"):
            _, caps = run_block(layer, cfg, x, cos, sin, mask, capture=True,
                                compute_dtype=compute_dtype)
        with stage(clock, "hessians"):
            for name, h in accumulate_hessians(caps).items():
                hessians[name] = hessians[name] + h if name in hessians else h
        del caps
    return hessians


def propagate(layer, cfg: ModelConfig, states, rope, compute_dtype,
              clock: Optional[StageClock] = None) -> List[torch.Tensor]:
    """The calibration hidden states after ``layer``."""
    cos, sin, mask = rope
    with stage(clock, "propagation"):
        return [run_block(layer, cfg, x, cos, sin, mask,
                          compute_dtype=compute_dtype)[0] for x in states]
