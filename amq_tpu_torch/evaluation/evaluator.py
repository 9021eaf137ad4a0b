"""Architecture evaluator, search mode: JSD of a proxy-stitched model
against the dense model's cached logits.

The port of the search mode of the JAX package's
``evaluation/evaluator.py``:

* the dense model's logits over every dataset are computed once (the
  plain layer-by-layer ``llama.forward``, at batch <= 4), rounded through
  bf16 to fp16 as the JAX cache stores them, and kept on the device,
* the 2/3/4-bit HQQ proxies are built one bit width at a time with bf16
  scale/zero and folded into one switch model
  (``stack_proxies(fuse="never")``), after which the dense model is no
  longer referenced,
* ``sample(arch)`` sets the switch model's per-layer selectors, and a loss
  is the mean per-sample JSD over the dataset, the ragged last batch
  padded by repeating its final row (pad rows are dropped),
* when one f32 ``[B, S, V]`` logits buffer would exceed 1 GiB the loss
  batch is capped to keep it under, the JSD is taken 256 rows at a time
  and the student logits are bf16 (the JAX package's rule).

Linears run dequantize-then-matmul (evaluation batches are far above the
decode kernels' M), attention at S >= 128 on the card through the flash
kernel unless ``use_kernels=False`` sends it through the einsum path.

Not ported here: final mode (real PTQ + perplexity), the data-parallel
mesh, the fp8 / device-resident / host-streamed cache modes and the
layer-chunked dense pass (an 80 GB card holds the 13.5 GB bf16 dense
model whole).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device, synchronize
from ..models import llama
from ..models.config import ModelConfig
from ..models.stacked import forward_stacked, set_arch, stack_proxies
from ..models.transform import Arch, quantize_model
from . import metrics


class Evaluator:
    """``eval(arch) -> ({dataset: JSD loss}, bits usage)`` over proxies.

    ``dense_params`` (an ``init_params``-shaped dict on the evaluation
    device) gives the dense logits and, unless ``proxies`` is given, the
    proxies.  ``proxies`` are per-bit ``quantize_model`` outputs or
    zero-argument callables returning them.  ``device`` defaults to CUDA
    and raises without a card; pass ``device="cpu"`` for the plain path.
    """

    search = True

    def __init__(self, cfg: ModelConfig,
                 dense_params: Optional[Dict[str, Any]] = None,
                 proxies: Optional[Sequence[Any]] = None,
                 bits_range: Sequence[int] = (2, 3, 4),
                 datasets: Optional[Dict[str, np.ndarray]] = None,
                 group_size: int = 128, batch_size: int = 8,
                 compute_dtype=torch.float32, use_kernels: bool = True,
                 device=None):
        self.device = resolve_device(device)
        if dense_params is None:
            raise ValueError("the dense model is needed for its logits")
        self.cfg = cfg
        self.topology = cfg.topology()
        self.bits_range = list(bits_range)
        self.group_size = group_size
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.datasets = dict(datasets or {})

        seqlen = max((int(t.shape[1]) for t in self.datasets.values()),
                     default=0)
        row_gib = seqlen * cfg.vocab_size * 4 / 2**30
        big = batch_size * row_gib > 1.0
        self._jsd_chunk = 256 if big else 0
        self._loss_dtype = torch.bfloat16 if big else torch.float32
        self._loss_batch = (min(batch_size, max(1, int(1.0 // row_gib)))
                            if big else batch_size)

        t0 = time.perf_counter()
        self.dense_logits: Dict[str, torch.Tensor] = {
            name: self._dense_pass(dense_params, toks)
            for name, toks in self.datasets.items()}
        synchronize(self.device)
        t1 = time.perf_counter()
        if proxies is None:
            proxies = [(lambda b=b: quantize_model(
                dense_params, cfg, b, group_size, meta_dtype=torch.bfloat16))
                for b in self.bits_range]
        self.switch_params = stack_proxies(proxies, self.bits_range,
                                           fuse="never", lane_pad=False)
        synchronize(self.device)
        #: wall seconds of the two set-up phases
        self.setup_s = {"dense_logits": t1 - t0,
                        "proxies": time.perf_counter() - t1}

    # -- low level ---------------------------------------------------------

    def kernels(self):
        """The kernel routing (flash attention, dequantization) of this
        evaluator's forwards."""
        return llama.forward_kernels(self.use_kernels)

    def tokens(self, batch: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(batch, dtype=torch.int64, device=self.device)

    def _batches(self, tokens: np.ndarray, batch_size: Optional[int] = None
                 ) -> Iterator[Tuple[np.ndarray, int]]:
        """``(batch [B, S], n_valid)`` with the last batch padded up to B by
        repeating its final row."""
        B = batch_size or self.batch_size
        for i in range(0, tokens.shape[0], B):
            batch = tokens[i:i + B]
            n_valid = batch.shape[0]
            if n_valid < B:
                pad = np.repeat(batch[-1:], B - n_valid, axis=0)
                batch = np.concatenate([batch, pad], axis=0)
            yield batch, n_valid

    def loss_batches(self, name: str) -> List[Tuple[np.ndarray, int, int]]:
        """``(batch, n_valid, first row)`` of one dataset at the loss batch."""
        out, start = [], 0
        for batch, n_valid in self._batches(self.datasets[name],
                                            self._loss_batch):
            out.append((batch, n_valid, start))
            start += n_valid
        return out

    @torch.inference_mode()
    def _dense_pass(self, params, tokens: np.ndarray) -> torch.Tensor:
        """fp16 dense logits ``[N, S, V]`` on the device (batch <= 4)."""
        outs = []
        with self.kernels():
            for batch, n_valid in self._batches(tokens,
                                                min(self.batch_size, 4)):
                logits, _ = llama.forward(params, self.cfg, self.tokens(batch),
                                          compute_dtype=self.compute_dtype)
                outs.append(logits[:n_valid].to(torch.bfloat16)
                            .to(torch.float16))
        return torch.cat(outs)

    @staticmethod
    def dense_batch(dense_logits: torch.Tensor, start: int, n_valid: int,
                    B: int) -> torch.Tensor:
        """Rows ``[start, start + n_valid)`` padded to B like the tokens."""
        dense = dense_logits[start:start + n_valid]
        if n_valid < B:
            dense = torch.cat([dense, dense[-1:].expand(B - n_valid,
                                                        *dense.shape[1:])])
        return dense

    def loss_of_logits(self, logits: torch.Tensor,
                       dense: torch.Tensor) -> torch.Tensor:
        """Per-sample JSD ``[B]`` of student logits against dense ones."""
        return metrics.jsd_shifted_per_sample(logits.to(self._loss_dtype),
                                              dense, chunk=self._jsd_chunk)

    @torch.inference_mode()
    def _loss(self, params, tokens: np.ndarray,
              dense_logits: torch.Tensor) -> torch.Tensor:
        """Mean per-sample JSD as a 0-d device tensor (no host sync)."""
        per_sample, start = [], 0
        with self.kernels():
            for batch, n_valid in self._batches(tokens, self._loss_batch):
                dense = self.dense_batch(dense_logits, start, n_valid,
                                         batch.shape[0])
                logits, _ = forward_stacked(params, self.cfg,
                                            self.tokens(batch),
                                            compute_dtype=self.compute_dtype)
                per_sample.append(self.loss_of_logits(logits, dense)[:n_valid])
                start += n_valid
        return torch.cat(per_sample).mean()

    # -- reference API -----------------------------------------------------

    def sample(self, arch: Arch):
        self.switch_params = set_arch(self.switch_params, arch)
        return self.switch_params

    def eval_loss(self, params, tokens: np.ndarray,
                  dense_logits: torch.Tensor) -> float:
        return float(self._loss(params, tokens, dense_logits))

    def eval_many(self, archs: Sequence[Arch]) -> List[tuple]:
        """``[({dataset: loss}, bits), ...]``, the same numbers as ``eval``
        per arch, read back from the device once."""
        archs = list(archs)
        names = list(self.datasets)
        losses = torch.stack([
            self._loss(self.sample(a), self.datasets[n], self.dense_logits[n])
            for a in archs for n in names]).tolist()
        return [({n: losses[i * len(names) + j] for j, n in enumerate(names)},
                 metrics.get_bits_usage(a, self.topology, self.group_size))
                for i, a in enumerate(archs)]

    def eval(self, architecture: Arch) -> Tuple[Dict[str, float], float]:
        """({dataset: loss}, bits usage)."""
        return self.eval_many([architecture])[0]
