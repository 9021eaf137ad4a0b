"""Post-training quantization: GPTQ, AWQ, OWQ (and HQQ through
``models.transform``), realizing a searched per-layer bit assignment."""

from .api import METHODS, get_calib_tokens, get_quantized_params  # noqa: F401
