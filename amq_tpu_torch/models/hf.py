"""Local Hugging Face checkpoints: safetensors <-> parameter dict.

The port of the JAX package's ``models/hf.py``.  The safetensors files
are read and written by a small codec of its own (:func:`read_safetensors`,
:func:`write_safetensors`), so neither ``safetensors`` nor
``transformers`` is needed: a file is an 8-byte little-endian header
length, a JSON header mapping each name to ``dtype`` / ``shape`` /
``data_offsets`` (byte offsets into the data that follows), then the raw
little-endian bytes.  BF16 tensors stay bf16.  Only :func:`load_tokenizer`
imports ``transformers``, and only when a tokenizer is asked for.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import LINEAR_NAMES, ModelConfig, register
from .linear import DenseLinear

# HF state-dict names per parameter slot
_HF_LAYER = {
    "input_norm": "model.layers.{i}.input_layernorm.weight",
    "post_norm": "model.layers.{i}.post_attention_layernorm.weight",
    **{name: f"model.layers.{{i}}.{name}.weight" for name in LINEAR_NAMES},
}

#: safetensors dtype tag <-> torch dtype
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_TAGS = {dt: tag for tag, dt in _DTYPES.items()}


def read_safetensors(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            a, b = info["data_offsets"]
            f.seek(8 + n + a)
            raw = np.frombuffer(bytearray(f.read(b - a)), dtype=np.uint8)
            t = torch.from_numpy(raw).view(_DTYPES[info["dtype"]])
            out[name] = t.reshape(info["shape"]).to(device)
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device) as one ``.safetensors`` file."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)        # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def config_from_hf(path: str) -> ModelConfig:
    """Build (and register) a ModelConfig from an HF ``config.json``."""
    with open(os.path.join(path, "config.json")) as f:
        hc = json.load(f)
    rope_scaling = hc.get("rope_scaling") or {}
    cfg = ModelConfig(
        name=os.path.basename(os.path.normpath(path)),
        vocab_size=hc["vocab_size"],
        hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"],
        num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        head_dim=hc.get("head_dim"),
        rms_norm_eps=hc.get("rms_norm_eps", 1e-5),
        rope_theta=hc.get("rope_theta", 10000.0),
        rope_scaling_llama3=(rope_scaling.get("rope_type") == "llama3"),
        qkv_bias=(hc.get("model_type") == "qwen2"),
        tie_word_embeddings=hc.get("tie_word_embeddings", False),
        sliding_window=hc.get("sliding_window"),
        max_position_embeddings=hc.get("max_position_embeddings", 4096),
    )
    return register(cfg)


def save_hf_checkpoint(params: Dict[str, Any], cfg: ModelConfig, path: str,
                       dtype=torch.float32) -> None:
    """Write a parameter dict as an HF checkpoint directory
    (``model.safetensors`` + ``config.json``), the inverse of
    :func:`load_hf_params`."""
    os.makedirs(path, exist_ok=True)

    def cast(t):
        return t.detach().to(dtype)

    tensors: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": cast(params["embed"]),
        "model.norm.weight": cast(params["final_norm"]),
    }
    if "lm_head" in params:
        tensors["lm_head.weight"] = cast(params["lm_head"].weight)
    for i, layer in enumerate(params["layers"]):
        for slot, pat in _HF_LAYER.items():
            key = pat.format(i=i)
            if slot in LINEAR_NAMES:
                tensors[key] = cast(layer[slot].weight)
                if layer[slot].bias is not None:
                    tensors[key.replace(".weight", ".bias")] = cast(
                        layer[slot].bias)
            else:
                tensors[key] = cast(layer[slot])
    write_safetensors(tensors, os.path.join(path, "model.safetensors"))

    hf_cfg = {
        "model_type": "qwen2" if cfg.qkv_bias else "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim_,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "sliding_window": cfg.sliding_window,
        "max_position_embeddings": cfg.max_position_embeddings,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)


def save_dummy_tokenizer(path: str, vocab_size: int) -> None:
    """Write a minimal WordLevel ``tokenizer.json`` that
    ``transformers.PreTrainedTokenizerFast`` loads (words ``w1`` ...)."""
    vocab = {"[UNK]": 0}
    vocab.update({f"w{i}": i for i in range(1, vocab_size)})
    tok = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [
            {"id": 0, "content": "[UNK]", "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True}
        ],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "[UNK]"},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(tok, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "unk_token": "[UNK]"}, f)


def load_tokenizer(path: str):
    """Local-files-only tokenizer (imports ``transformers`` here)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


def load_hf_params(path: str, cfg: Optional[ModelConfig] = None,
                   dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Load a local HF llama-family checkpoint directory onto ``device``."""
    cfg = cfg or config_from_hf(path)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f, device))

    def get(name):
        return tensors.pop(name).to(dtype)

    params: Dict[str, Any] = {"embed": get("model.embed_tokens.weight"),
                              "final_norm": get("model.norm.weight"),
                              "layers": []}
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = DenseLinear(weight=get("lm_head.weight"))
    for i in range(cfg.num_layers):
        layer: Dict[str, Any] = {}
        for slot, pat in _HF_LAYER.items():
            key = pat.format(i=i)
            if slot in LINEAR_NAMES:
                bias_key = key.replace(".weight", ".bias")
                bias = get(bias_key) if bias_key in tensors else None
                layer[slot] = DenseLinear(weight=get(key), bias=bias)
            else:
                layer[slot] = get(key)
        params["layers"].append(layer)
    return params
