"""Serving engine: prefill and greedy decode over a packed mixed-bit model.

The port of ``Engine`` from the JAX package's ``serving/engine.py``.  The
JAX engine runs decode as an on-device ``lax.scan``; here it is a Python
loop over steps in which nothing is read back to the host until the loop
ends: the argmax stays on the card, and the cache length (and the per-row
offsets derived from it) are device tensors.  The KV cache is read-only
inside the layer loop; each step's keys and values are appended once,
after all layers, in place into the cache's buffers (``forward_stacked``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.linear import QuantLinear, kernel_linears
from ..models.stacked import StackedModel, forward_stacked
from ..ops.quant_matmul import quant_matmul


def kernel_linear_impl(p: QuantLinear, x: torch.Tensor, compute_dtype):
    """QuantLinear application through the dequant-matmul kernel."""
    y = quant_matmul(x.contiguous(), p.qt, out_dtype=compute_dtype)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


@dataclasses.dataclass
class Engine:
    """Single-stream serving engine over a stacked or per-layer model.

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch path.  ``use_kernels=False``
    takes the dequantize-then-matmul path and the einsum attention
    everywhere.
    """

    params: Any
    cfg: ModelConfig
    batch_size: int = 1
    max_len: int = 2048
    compute_dtype: Any = torch.bfloat16
    use_kernels: bool = True
    cache_dtype: Any = torch.bfloat16
    device: Optional[Any] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._impl = kernel_linear_impl if self.use_kernels else None

    def new_cache(self) -> llama.KVCache:
        return llama.KVCache.create(self.cfg, self.batch_size, self.max_len,
                                    dtype=self.cache_dtype, device=self.device)

    def _forward(self, params, tokens, cache):
        with kernel_linears(self._impl), \
                llama.attention_kernels(self.use_kernels):
            if isinstance(params, StackedModel):
                return forward_stacked(params, self.cfg, tokens, cache=cache,
                                       compute_dtype=self.compute_dtype)
            return llama.forward(params, self.cfg, tokens, cache=cache,
                                 compute_dtype=self.compute_dtype)

    @torch.inference_mode()
    def _prefill(self, params, tokens: torch.Tensor, cache: llama.KVCache):
        """Last-position logits [B, V] and the filled cache."""
        logits, cache = self._forward(params, tokens, cache)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def _prefill_token(self, params, tokens: torch.Tensor,
                       cache: llama.KVCache):
        """Prefill and greedy first token [B] (int32, on the device)."""
        last, cache = self._prefill(params, tokens, cache)
        return torch.argmax(last, dim=-1).to(torch.int32), cache

    @torch.inference_mode()
    def _decode_n(self, params, first_token: torch.Tensor,
                  cache: llama.KVCache, n_steps: int):
        """Greedy-decode ``n_steps`` tokens -> ([B, n_steps] int32, cache)."""
        B = first_token.shape[0]
        toks = torch.empty((B, n_steps), dtype=torch.int32, device=self.device)
        tok = first_token
        for s in range(n_steps):
            logits, cache = self._forward(params, tok[:, None], cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            toks[:, s] = tok
        return toks, cache

    def tokens_to_device(self, prompt_tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64,
                               device=self.device)

    def generate(self, prompt_tokens: np.ndarray,
                 max_new_tokens: int = 128) -> np.ndarray:
        """Greedy generation; prompt [B, S] -> [B, max_new_tokens]."""
        B, S = prompt_tokens.shape
        assert B == self.batch_size, (B, self.batch_size)
        cache = self.new_cache()
        first, cache = self._prefill_token(
            self.params, self.tokens_to_device(prompt_tokens), cache)
        rest, _ = self._decode_n(self.params, first, cache,
                                 n_steps=max_new_tokens - 1)
        out = torch.cat([first[:, None], rest], dim=1)
        return out.cpu().numpy()
