"""Model configuration and registry (pure data).

The port keeps its own copy of the JAX package's ``models/config.py`` so
that it imports nothing of the JAX package: the same ``ModelConfig`` fields,
registry entries, ``LINEAR_NAMES`` and ``cycled_arch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# linear sites inside one decoder block, reference naming
# (amq/configs/llama.json "linear")
LINEAR_NAMES = (
    "self_attn.q_proj",
    "self_attn.k_proj",
    "self_attn.v_proj",
    "self_attn.o_proj",
    "mlp.gate_proj",
    "mlp.up_proj",
    "mlp.down_proj",
)


def cycled_arch(num_layers: int, bits_range=(2, 3, 4)) -> dict:
    """Default mixed-bit demo arch: bits cycled over (site, layer) so
    every width appears at every depth — the benchmarks' shared stand-in
    when no searched ``iter_N.stats`` arch is given."""
    n = len(bits_range)
    return {"linear": {l: [bits_range[(i + j) % n] for i in range(num_layers)]
                       for j, l in enumerate(LINEAR_NAMES)}}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None  # defaults to hidden // heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_llama3: bool = False  # Llama-3.1-style rope scaling
    qkv_bias: bool = False             # Qwen2 family
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None  # Mistral
    max_position_embeddings: int = 4096

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    def linear_shape(self, linear: str) -> Tuple[int, int]:
        """(out_features, in_features) per linear site, reference orientation."""
        h, i = self.hidden_size, self.intermediate_size
        return {
            "self_attn.q_proj": (self.q_dim, h),
            "self_attn.k_proj": (self.kv_dim, h),
            "self_attn.v_proj": (self.kv_dim, h),
            "self_attn.o_proj": (h, self.q_dim),
            "mlp.gate_proj": (i, h),
            "mlp.up_proj": (i, h),
            "mlp.down_proj": (h, i),
        }[linear]

    def block_numel(self) -> int:
        return sum(o * i for o, i in (self.linear_shape(l) for l in LINEAR_NAMES))

    def model_numel(self) -> int:
        """Weights counted by the reference's avg-bits denominator.

        The reference's configs record only the decoder-block linears
        (e.g. llama.json model_numel 6476005376 = 32 blocks of Llama-2-7B),
        excluding embeddings/norms — avg bits are over quantized weights.
        """
        return self.block_numel() * self.num_layers

    def topology(self) -> Dict:
        """Reference-schema topology dict (amq/configs/llama.json:2-27)."""
        shapes = {l: list(self.linear_shape(l)) for l in LINEAR_NAMES}
        attn = sum(
            o * i for l, (o, i) in shapes.items() if l.startswith("self_attn")
        )
        mlp = sum(o * i for l, (o, i) in shapes.items() if l.startswith("mlp"))
        return {
            "n_block": self.num_layers,
            "n_layer": 2,
            "layer": ["self_attn", "mlp"],
            "layer_numel": {"self_attn": attn, "mlp": mlp},
            "n_linear": len(LINEAR_NAMES),
            "linear": list(LINEAR_NAMES),
            "linear_shape": shapes,
            "hierarchy": {l: l.split(".")[0] for l in LINEAR_NAMES},
            "model_numel": self.model_numel(),
            "model": "model",
            "layers": "model.layers",
            "pre_layer": ["model.embed_tokens"],
            "post_layer": ["model.norm", "lm_head", "model.rotary_emb"],
        }


def _llama2(name, h, i, n, heads, kv_heads=None, vocab=32000):
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=h, intermediate_size=i,
        num_layers=n, num_heads=heads, num_kv_heads=kv_heads or heads,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096,
    )


REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


register(_llama2("Llama-2-7b-hf", 4096, 11008, 32, 32))
register(_llama2("Llama-2-13b-hf", 5120, 13824, 40, 40))
register(_llama2("Llama-2-70b-hf", 8192, 28672, 80, 64, kv_heads=8))
register(ModelConfig(
    name="Meta-Llama-3-8B", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=500000.0, max_position_embeddings=8192,
))
register(ModelConfig(
    name="Llama-3.1-8B", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=500000.0, rope_scaling_llama3=True,
    max_position_embeddings=131072,
))
register(ModelConfig(
    name="Llama-3.1-8B-Instruct", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=500000.0, rope_scaling_llama3=True,
    max_position_embeddings=131072,
))
register(ModelConfig(
    name="Llama-3.1-70B", vocab_size=128256, hidden_size=8192,
    intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
    rope_theta=500000.0, rope_scaling_llama3=True,
    max_position_embeddings=131072,
))
register(ModelConfig(
    name="Mistral-7B-v0.3", vocab_size=32768, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=1000000.0, max_position_embeddings=32768,
))
for _n, _h, _i, _l, _hd, _kv, _vocab in (
    ("Qwen2-0.5B", 896, 4864, 24, 14, 2, 151936),
    ("Qwen2.5-7B", 3584, 18944, 28, 28, 4, 152064),
    ("Qwen2.5-14B", 5120, 13824, 48, 40, 8, 152064),
    ("Qwen2.5-32B", 5120, 27648, 64, 40, 8, 152064),
    ("Qwen2.5-72B", 8192, 29568, 80, 64, 8, 152064),
):
    register(ModelConfig(
        name=_n, vocab_size=_vocab, hidden_size=_h, intermediate_size=_i,
        num_layers=_l, num_heads=_hd, num_kv_heads=_kv, qkv_bias=True,
        rms_norm_eps=1e-6, rope_theta=1000000.0,
        tie_word_embeddings=(_n == "Qwen2-0.5B"),
        max_position_embeddings=32768,
    ))

# tiny synthetic configs for tests / CI (in-feature dims multiples of 128
# so group quantization applies end-to-end)
register(ModelConfig(
    name="tiny-llama", vocab_size=512, hidden_size=256, intermediate_size=512,
    num_layers=4, num_heads=4, num_kv_heads=2, max_position_embeddings=512,
))
register(ModelConfig(
    name="tiny-qwen2", vocab_size=512, hidden_size=256, intermediate_size=384,
    num_layers=2, num_heads=4, num_kv_heads=2, qkv_bias=True,
    rms_norm_eps=1e-6, tie_word_embeddings=True, max_position_embeddings=512,
))
# dims chosen so tensor-parallel shards stay group-aligned up to tp=4:
# all row-parallel K shards (512/4, 1024/4) are multiples of group 128
register(ModelConfig(
    name="graft-tp", vocab_size=512, hidden_size=512, intermediate_size=1024,
    num_layers=4, num_heads=8, num_kv_heads=8, head_dim=64,
    max_position_embeddings=512,
))


def get_config(name: str) -> ModelConfig:
    key = name.rsplit("/", 1)[-1]
    if key not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[key]
