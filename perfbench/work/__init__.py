"""FLOPs and bytes reckoned from model shapes and from the tokens of the
window, never from the port's launch counters: a metric reads the same
work whatever kernel carries it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 3.35 TB/s of HBM.  A product's least time is the
larger of its FLOPs over the peak and its bytes over the bandwidth, each
input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def dims(shape: dict) -> dict:
    """The sizes the reckoning needs, from a configuration's shape keys."""
    H = shape["hidden_size"]
    Hq = shape["num_attention_heads"]
    d = shape.get("head_dim") or H // Hq
    return dict(H=H, I=shape["intermediate_size"], L=shape["num_hidden_layers"],
                V=shape["vocab_size"], Hq=Hq, Hkv=shape["num_key_value_heads"],
                d=d)


def products(shape: dict) -> Dict[str, Tuple[int, int]]:
    """``(N, K)`` of each fused linear site of one layer and of the head."""
    s = dims(shape)
    q, kv = s["Hq"] * s["d"], s["Hkv"] * s["d"]
    return {"qkv": (q + 2 * kv, s["H"]), "o": (s["H"], q),
            "gateup": (2 * s["I"], s["H"]), "down": (s["H"], s["I"]),
            "head": (s["V"], s["H"])}


def linear_params(shape: dict) -> int:
    """Weights of every layer's linears and of the head."""
    s = dims(shape)
    p = products(shape)
    return s["L"] * sum(n * k for site, (n, k) in p.items() if site != "head") \
        + p["head"][0] * p["head"][1]


def attention_flops(shape: dict, queries: int, first_key: int) -> float:
    """Causal attention FLOPs of ``queries`` consecutive positions starting
    at position ``first_key`` (the keys before them are cached): QK^T and
    PV, 2 FLOPs a multiply-add, every layer."""
    s = dims(shape)
    keys = queries * first_key + queries * (queries + 1) // 2
    return 4.0 * s["L"] * s["Hq"] * s["d"] * keys


def prefill_flops(shape: dict, prompt_len: int) -> float:
    """Model FLOPs of a prompt's real tokens from an empty cache."""
    return (2.0 * linear_params(shape) * prompt_len
            + attention_flops(shape, prompt_len, 0))


def decode_flops(shape: dict, tokens: int, keys: int) -> float:
    """Model FLOPs of ``tokens`` generated tokens that attend ``keys`` keys
    in all (each its cached context and itself)."""
    s = dims(shape)
    return (2.0 * linear_params(shape) * tokens
            + 4.0 * s["L"] * s["Hq"] * s["d"] * keys)


def product_work(n: int, k: int, rows: int, bits: int, group: int,
                 out_bytes: int = 2, x_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one packed ``[K, N]`` product at ``rows``
    real rows: the words at ``bits`` per weight and the bf16 scale and
    zero of each group, read once; x read and the output written once."""
    weight = k * n * bits / 8 + 2 * 2 * (k // group) * n
    return 2.0 * rows * n * k, weight + rows * k * x_bytes + rows * n * out_bytes


def step_products(shape: dict, quant: dict, rows: int) -> Iterable[Tuple[float, float]]:
    """(FLOPs, bytes) of every quantized product of one forward at ``rows``
    real rows: each layer's four sites at its container width, then the
    head (float32 logits)."""
    s = dims(shape)
    p = products(shape)
    cycle, group = quant["layer_bits_cycle"], quant["group_size"]
    cont = {int(b): c for b, c in quant["containers"].items()}
    for i in range(s["L"]):
        b = cycle[i % len(cycle)]
        bits = cont.get(b, b)
        for site in ("qkv", "o", "gateup", "down"):
            n, k = p[site]
            yield product_work(n, k, rows, bits, group)
    n, k = p["head"]
    yield product_work(n, k, rows, quant["head_bits"], group, out_bytes=4)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def products_seconds(shape: dict, quant: dict, row_counts: List[int]) -> float:
    """Least seconds of the quantized products of forwards at each of
    ``row_counts`` real rows, bounded product by product."""
    per_rows: Dict[int, float] = {}
    for rows in row_counts:
        if rows not in per_rows:
            per_rows[rows] = sum(least_seconds(f, b) for f, b in
                                 step_products(shape, quant, rows))
    return sum(per_rows[r] for r in row_counts)
