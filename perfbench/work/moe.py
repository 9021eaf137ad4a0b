"""FLOPs and bytes of a sparse (Qwen2-MoE) model, reckoned from its
shapes and from what the window did (tokens, keys, and the experts the
router chose as the port's device counters report them), never from
launch counts: a metric reads the same work whatever kernel carries it.

Active parameters of a token: the attention's linears, the shared
expert's three, ``k`` routed experts' three, the router and the
shared-expert gate, and the head.  Peaks as in ``perfbench.work``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from perfbench import work


def dims(shape: dict) -> dict:
    """``perfbench.work.dims`` plus the sparse block's sizes."""
    return dict(work.dims(shape), E=shape["num_experts"],
                k=shape["num_experts_per_tok"],
                Ie=shape["moe_intermediate_size"],
                Is=shape["shared_expert_intermediate_size"])


def products(shape: dict) -> Dict[str, Tuple[int, int]]:
    """``(N, K)`` of each fused site of one layer (a routed expert's are
    one expert's) and of the head."""
    s = dims(shape)
    p = work.products(shape)
    return {"qkv": p["qkv"], "o": p["o"],
            "shared_gateup": (2 * s["Is"], s["H"]),
            "shared_down": (s["H"], s["Is"]),
            "gateup": (2 * s["Ie"], s["H"]), "down": (s["H"], s["Ie"]),
            "head": p["head"]}


def active_params(shape: dict) -> int:
    """Weights one token's forward multiplies: per layer the attention,
    the shared expert, ``k`` experts, the router and the shared gate; and
    the head."""
    s = dims(shape)
    p = products(shape)
    layer = sum(p[n][0] * p[n][1] for n in ("qkv", "o", "shared_gateup",
                                            "shared_down"))
    layer += s["k"] * sum(p[n][0] * p[n][1] for n in ("gateup", "down"))
    layer += s["E"] * s["H"] + s["H"]
    return s["L"] * layer + p["head"][0] * p["head"][1]


def prefill_flops(shape: dict, prompt_len: int) -> float:
    """Model FLOPs of a prompt's real tokens from an empty cache."""
    return (2.0 * active_params(shape) * prompt_len
            + work.attention_flops(shape, prompt_len, 0))


def decode_flops(shape: dict, tokens: int, keys: int) -> float:
    """Model FLOPs of ``tokens`` generated tokens attending ``keys`` keys
    in all."""
    s = dims(shape)
    return (2.0 * active_params(shape) * tokens
            + 4.0 * s["L"] * s["Hq"] * s["d"] * keys)


def layer_container_bits(shape: dict, quant: dict) -> List[int]:
    """Each layer's stored width (its cycled bits in their container)."""
    cycle = quant["layer_bits_cycle"]
    cont = {int(b): c for b, c in quant["containers"].items()}
    return [cont.get(cycle[i % len(cycle)], cycle[i % len(cycle)])
            for i in range(shape["num_hidden_layers"])]


def expert_bytes(shape: dict, quant: dict, bits: int) -> float:
    """One routed expert's words at ``bits`` and its bf16 scale and zero
    (gate|up and down), each read once."""
    p = products(shape)
    g = quant["group_size"]
    return sum(n * k * bits / 8 + 2 * 2 * (k // g) * n
               for n, k in (p["gateup"], p["down"]))


def expert_products_seconds(shape: dict, quant: dict,
                            hits_by_layer: List[int], pairs: int) -> float:
    """Least seconds of the routed-expert products of a stretch of steps:
    each expert the router chose, in each layer and step, read once
    (``hits_by_layer``: their count per layer, summed over the steps),
    and per pair (``pairs`` over all layers) x read and the output
    written in bf16 once; FLOPs 2 x pairs x an expert's weights.  The
    larger of the two bounds over the stretch (decode steps are bytes
    bound by two orders of magnitude)."""
    s = dims(shape)
    p = products(shape)
    nbytes = sum(h * expert_bytes(shape, quant, b) for h, b in
                 zip(hits_by_layer, layer_container_bits(shape, quant)))
    nbytes += pairs * 2 * 2 * s["H"]
    flops = 2.0 * pairs * sum(n * k for n, k in (p["gateup"], p["down"]))
    return work.least_seconds(flops, nbytes)


def dense_step_products(shape: dict, quant: dict,
                        rows: int) -> Iterable[Tuple[float, float]]:
    """(FLOPs, bytes) of each product of one forward at ``rows`` real rows
    that the dense sites' kernels carry: per layer the attention's qkv and
    o and the shared expert's gate|up and down at the layer's container
    width, then the head (float32 logits); ``perfbench.work.product_work``
    each.  The routed experts are :func:`expert_products_seconds`'."""
    p = products(shape)
    g = quant["group_size"]
    for bits in layer_container_bits(shape, quant):
        for site in ("qkv", "o", "shared_gateup", "shared_down"):
            n, k = p[site]
            yield work.product_work(n, k, rows, bits, g)
    n, k = p["head"]
    yield work.product_work(n, k, rows, quant["head_bits"], g, out_bytes=4)


def dense_products_seconds(shape: dict, quant: dict,
                           row_counts: List[int]) -> float:
    """Least seconds of :func:`dense_step_products` over forwards at each
    of ``row_counts`` real rows, bounded product by product."""
    per_rows: Dict[int, float] = {}
    for rows in row_counts:
        if rows not in per_rows:
            per_rows[rows] = sum(work.least_seconds(f, b) for f, b in
                                 dense_step_products(shape, quant, rows))
    return sum(per_rows[r] for r in row_counts)
