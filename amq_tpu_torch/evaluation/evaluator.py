"""Architecture evaluator: JSD of a proxy-stitched model against the
dense model's cached logits (search mode), or the perplexity of a real
PTQ realization (final mode).

The port of the JAX package's ``evaluation/evaluator.py``.  Search mode:

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

Final mode (``search=False``): ``sample(arch, method)`` runs
``quantize_fn(dense params, cfg, arch, method)`` (a real PTQ algorithm) and
``eval`` reports each dataset's perplexity, ``exp`` of the mean per-sample
shifted cross-entropy, through the plain ``llama.forward`` at batch <= 4
(the ragged last batch padded as in search mode).  Packed HQQ linears are
dequantized once per layer first (``models.linear.dequantize_weight``: the
dequantization kernel on the card).

Data parallelism (``data_group``, the JAX package's 'data' mesh and the
reference's Accelerate data-parallel evaluation): every dataset's samples
are split over the group's ranks in contiguous blocks, each rank computes
the dense logits and the per-sample losses of its own block, and the
per-sample values are gathered back in sample order before the mean, so
a loss is the same mean over the same per-sample values as in one
process.  Every rank calls the same methods with the same archs.

Not ported here: the fp8 / device-resident / host-streamed cache modes and
the layer-chunked dense pass, in both modes (an 80 GB card holds the
13.5 GB bf16 dense model whole).
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device, synchronize
from ..models import llama
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import DenseLinear, QuantLinear, dequantize_weight
from ..models.stacked import forward_stacked, set_arch, stack_proxies
from ..models.transform import Arch, quantize_model
from ..parallel import comm
from . import metrics


class Evaluator:
    """``eval(arch) -> ({dataset: JSD loss}, bits usage)`` over proxies, or
    with ``search=False``, ``eval(arch, method) -> ({dataset: perplexity},
    bits usage)`` of ``quantize_fn``'s realization.

    ``dense_params`` (an ``init_params``-shaped dict on the evaluation
    device) gives the dense logits and, unless ``proxies`` is given, the
    proxies; in final mode it is what ``quantize_fn`` quantizes.
    ``proxies`` are per-bit ``quantize_model`` outputs or zero-argument
    callables returning them.  ``device`` defaults to CUDA and raises
    without a card; pass ``device="cpu"`` for the plain path.
    ``data_group`` splits the samples over that process group's ranks.
    """

    def __init__(self, cfg: ModelConfig,
                 dense_params: Optional[Dict[str, Any]] = None,
                 proxies: Optional[Sequence[Any]] = None,
                 bits_range: Sequence[int] = (2, 3, 4),
                 datasets: Optional[Dict[str, np.ndarray]] = None,
                 group_size: int = 128, batch_size: int = 8,
                 compute_dtype=torch.float32, use_kernels: bool = True,
                 device=None, search: bool = True,
                 quantize_fn: Optional[Callable] = None,
                 data_group=None):
        self.device = resolve_device(device)
        if dense_params is None:
            raise ValueError("the dense model is needed")
        self.cfg = cfg
        self.topology = cfg.topology()
        self.bits_range = list(bits_range)
        self.group_size = group_size
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.datasets = dict(datasets or {})
        self.search = search
        self.data_group = data_group
        #: this rank's rows of every dataset (all of them without a group)
        self.local = {name: toks[self._rows(len(toks))]
                      for name, toks in self.datasets.items()}
        if not search:
            if quantize_fn is None:
                raise ValueError("final mode needs quantize_fn")
            self.model_params = dense_params
            self.quantize_fn = quantize_fn
            return

        seqlen = max((int(t.shape[1]) for t in self.datasets.values()),
                     default=0)
        row_gib = seqlen * cfg.vocab_size * 4 / 2**30
        big = batch_size * row_gib > 1.0
        self._jsd_chunk = 256 if big else 0
        self._loss_dtype = torch.bfloat16 if big else torch.float32
        self._loss_batch = (min(batch_size, max(1, int(1.0 // row_gib)))
                            if big else batch_size)

        t0 = time.perf_counter()
        #: dense logits of this rank's rows (``self.local``)
        self.dense_logits: Dict[str, torch.Tensor] = {
            name: self._dense_pass(dense_params, toks)
            for name, toks in self.local.items()}
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

    def _rows(self, n: int) -> slice:
        """This rank's block of ``n`` samples: contiguous, sizes differing
        by at most one, lower ranks first."""
        if self.data_group is None:
            return slice(0, n)
        r = dist.get_rank(self.data_group)
        w = dist.get_world_size(self.data_group)
        base, rem = divmod(n, w)
        lo = r * base + min(r, rem)
        return slice(lo, lo + base + (r < rem))

    def gather_samples(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """Per-sample values of every rank's block, in sample order
        (``local``: this rank's ``[rows]``; ``n`` samples in all)."""
        if self.data_group is None:
            return local
        w = dist.get_world_size(self.data_group)
        width = -(-n // w)
        buf = torch.zeros(width, dtype=local.dtype, device=local.device)
        buf[:local.shape[0]] = local
        parts = comm.all_gather(buf, self.data_group)
        sizes = [n // w + (r < n % w) for r in range(w)]
        return torch.cat([p[:k] for p, k in zip(parts, sizes)])

    def reduce_sum(self, x: np.ndarray) -> np.ndarray:
        """``x`` summed over the data group's ranks (float64; ``x`` itself
        without a group)."""
        if self.data_group is None:
            return x
        t = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        return comm.all_reduce_(t, self.data_group).cpu().numpy()

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
        """``(batch, n_valid, first row)`` of this rank's rows of one
        dataset at the loss batch (rows of ``self.local``, whose dense
        logits ``self.dense_logits`` holds)."""
        out, start = [], 0
        for batch, n_valid in self._batches(self.local[name],
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
    def _loss(self, params, name: str) -> torch.Tensor:
        """Mean per-sample JSD over dataset ``name`` as a 0-d device
        tensor (no host sync without a data group)."""
        per_sample = [torch.zeros(0, device=self.device)]
        with self.kernels():
            for batch, n_valid, start in self.loss_batches(name):
                dense = self.dense_batch(self.dense_logits[name], start,
                                         n_valid, batch.shape[0])
                logits, _ = forward_stacked(params, self.cfg,
                                            self.tokens(batch),
                                            compute_dtype=self.compute_dtype)
                per_sample.append(self.loss_of_logits(logits, dense)[:n_valid])
        return self.gather_samples(torch.cat(per_sample),
                                   len(self.datasets[name])).mean()

    # -- reference API -----------------------------------------------------

    def sample(self, arch: Arch, method: str = "hqq"):
        if not self.search:
            return self.quantize_fn(self.model_params, self.cfg, arch, method)
        self.switch_params = set_arch(self.switch_params, arch)
        return self.switch_params

    def eval_loss(self, params, name: str) -> float:
        """Mean per-sample JSD of ``params`` over dataset ``name``."""
        return float(self._loss(params, name))

    def eval_many(self, archs: Sequence[Arch]) -> List[tuple]:
        """``[({dataset: loss}, bits), ...]``, the same numbers as ``eval``
        per arch, read back from the device once."""
        archs = list(archs)
        names = list(self.datasets)
        losses = torch.stack([self._loss(self.sample(a), n)
                              for a in archs for n in names]).tolist()
        return [({n: losses[i * len(names) + j] for j, n in enumerate(names)},
                 metrics.get_bits_usage(a, self.topology, self.group_size))
                for i, a in enumerate(archs)]

    def _dequantized(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Packed linears dequantized once, layer by layer, to dense ones
        in the compute dtype (the packed forward would dequantize them at
        every use: the same numbers)."""
        layers = []
        for layer in params["layers"]:
            layer = dict(layer)
            for name in LINEAR_NAMES:
                p = layer[name]
                if isinstance(p, QuantLinear):
                    wt = dequantize_weight(p.qt, self.compute_dtype)
                    layer[name] = DenseLinear(weight=wt.T, bias=p.bias)
            layers.append(layer)
        return {**params, "layers": layers}

    @torch.inference_mode()
    def eval_ppl(self, params: Dict[str, Any], tokens: np.ndarray) -> float:
        """``exp`` of the mean per-sample shifted cross-entropy over
        ``tokens`` (this rank's block of them under a data group)."""
        n = len(tokens)
        tokens = tokens[self._rows(n)]
        per_sample = [torch.zeros(0, device=self.device)]
        with self.kernels():
            params = self._dequantized(params)
            for batch, n_valid in self._batches(tokens,
                                                min(self.batch_size, 4)):
                toks = self.tokens(batch)
                logits, _ = llama.forward(params, self.cfg, toks,
                                          compute_dtype=self.compute_dtype)
                per_sample.append(metrics.cross_entropy_shifted_per_sample(
                    logits, toks)[:n_valid])
        return float(torch.exp(self.gather_samples(torch.cat(per_sample),
                                                   n).mean()))

    def eval(self, architecture: Arch, method: str = "hqq"
             ) -> Tuple[Dict[str, float], float]:
        """({dataset: loss or perplexity}, bits usage)."""
        if self.search:
            return self.eval_many([architecture])[0]
        params = self.sample(architecture, method)
        out = {name: self.eval_ppl(params, toks)
               for name, toks in self.datasets.items()}
        return out, metrics.get_bits_usage(architecture, self.topology,
                                           self.group_size)
