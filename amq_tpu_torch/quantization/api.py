"""PTQ method registry.

The port of the JAX package's ``quantization/api.py``:
``get_quantized_params(params, cfg, method, arch, ...)`` dispatches to
AWQ / GPTQ / OWQ / HQQ and returns a new parameter dict -- fake-quantized
dense weights for 'awq' / 'gptq' / 'owq' (OWQ's packed serving form with
``packed=True``), packed :class:`~amq_tpu_torch.models.linear.QuantLinear`
leaves for 'hqq'.  Each method calibrates on its reference dataset
(AWQ pileval, GPTQ C4, OWQ wikitext2), or on synthetic tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..evaluation import data as data_mod
from ..models import transform
from ..models.config import ModelConfig
from .awq import awq_quantize_model
from .gptq import gptq_quantize_model
from .owq import owq_quantize_model

METHODS = ("awq", "gptq", "owq", "hqq")

# reference calibration datasets and lengths per method
CALIB_DATASET = {"awq": "pileval", "gptq": "c4", "owq": "wikitext2"}
CALIB_SEQLEN = {"awq": 512, "gptq": 2048, "owq": 2048}


def get_calib_tokens(method: str, tokenizer=None, n_samples: int = 128,
                     seed: int = 0, synthetic_vocab: Optional[int] = None,
                     cache_dir: Optional[str] = None) -> np.ndarray:
    """``[n_samples, seqlen]`` calibration tokens of ``method``."""
    seqlen = CALIB_SEQLEN[method]
    if synthetic_vocab is not None:
        return data_mod.synthetic_tokens(synthetic_vocab, n_sample=n_samples,
                                         seqlen=seqlen, seed=seed)
    name = CALIB_DATASET[method]
    if name == "pileval":
        # c4 stands in only when the pile set cannot be read
        try:
            return data_mod.get_loader("pileval", tokenizer=tokenizer,
                                       n_sample=n_samples, seqlen=seqlen,
                                       cache_dir=cache_dir)
        except Exception:
            name = "c4"
    return data_mod.get_loader(name, tokenizer=tokenizer, n_sample=n_samples,
                               train=True, seed=seed, seqlen=seqlen,
                               cache_dir=cache_dir)


def get_quantized_params(params: Dict[str, Any], cfg: ModelConfig,
                         method: str, arch: transform.Arch,
                         avg_bits: Optional[float] = None,
                         group_size: int = 128,
                         calib_tokens: Optional[np.ndarray] = None,
                         tokenizer=None, synthetic_calib: bool = False,
                         n_samples: int = 128, **kwargs) -> Dict[str, Any]:
    assert method in METHODS, f"invalid method {method!r}"
    if method == "hqq":
        return transform.quantize_model(params, cfg, arch, group_size)
    if calib_tokens is None:
        calib_tokens = get_calib_tokens(
            method, tokenizer=tokenizer, n_samples=n_samples,
            synthetic_vocab=cfg.vocab_size if synthetic_calib else None)
    if method == "awq":
        return awq_quantize_model(params, cfg, arch, calib_tokens,
                                  group_size=group_size, **kwargs)
    if method == "gptq":
        return gptq_quantize_model(params, cfg, arch, calib_tokens,
                                   group_size=group_size, **kwargs)
    assert avg_bits is not None, "owq needs the target avg_bits"
    return owq_quantize_model(params, cfg, arch, avg_bits, calib_tokens,
                              group_size=group_size, **kwargs)
