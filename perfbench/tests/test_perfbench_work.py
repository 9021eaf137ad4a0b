"""The work reckoning against hand counts at the two configurations."""

from __future__ import annotations

import json
import types

import pytest

from perfbench import bench, work

CONF = {n: json.loads((bench.ROOT / "configs" / f"{n}.json").read_text())
        for n in ("mistral-7b-v0.3", "qwen2.5-7b")}

#: per layer q|k|v, o, gate|up, down weights, and the head, counted by hand
LAYER = {"mistral-7b-v0.3": 6144 * 4096 + 4096 * 4096 + 28672 * 4096
         + 4096 * 14336,                                   # 218,103,808
         "qwen2.5-7b": 4608 * 3584 + 3584 * 3584 + 37888 * 3584
         + 3584 * 18944}                                   # 233,046,016
HEAD = {"mistral-7b-v0.3": 32768 * 4096, "qwen2.5-7b": 152064 * 3584}
DEPTH = {"mistral-7b-v0.3": 32, "qwen2.5-7b": 28}


@pytest.mark.parametrize("name", sorted(CONF))
def test_linear_params(name):
    assert LAYER["mistral-7b-v0.3"] == 218_103_808
    assert LAYER["qwen2.5-7b"] == 233_046_016
    assert work.linear_params(CONF[name]["shape"]) == (
        DEPTH[name] * LAYER[name] + HEAD[name])


@pytest.mark.parametrize("name", sorted(CONF))
def test_decode_step_bytes(name):
    """Layer i at (2, 3, 4)[i % 3] bits, 3 in 4-bit containers; bf16 scale
    and zero per 128 rows; the 8-bit head; x and out at 8 rows."""
    c = CONF[name]
    L, H, V = DEPTH[name], c["shape"]["hidden_size"], c["shape"]["vocab_size"]
    two = sum(1 for i in range(L) if i % 3 == 0)
    words = (two * 2 + (L - two) * 4) * LAYER[name] // 8
    meta = L * 4 * LAYER[name] // 128
    head = HEAD[name] + 4 * (H // 128) * V
    N = {"qkv": (c["shape"]["num_attention_heads"] + 2
                 * c["shape"]["num_key_value_heads"]) * 128,
         "o": H, "gateup": 2 * c["shape"]["intermediate_size"], "down": H}
    K = {"qkv": H, "o": H, "gateup": H, "down": c["shape"]["intermediate_size"]}
    io = L * 8 * 2 * sum(N[s] + K[s] for s in N) + 8 * (2 * H + 4 * V)
    got = sum(b for _, b in work.step_products(c["shape"], c["quant"], 8))
    assert got == words + meta + head + io
    if name == "qwen2.5-7b":
        # the 8-bit head: 545 MB of words and 17 MB of meta
        assert head == 544_997_376 + 17_031_168


def test_decode_is_bandwidth_bound_and_real_rows_count():
    c = CONF["mistral-7b-v0.3"]
    t8 = work.products_seconds(c["shape"], c["quant"], [8])
    nbytes = sum(b for _, b in work.step_products(c["shape"], c["quant"], 8))
    assert t8 == pytest.approx(nbytes / work.HBM_BYTES_PER_S)
    # a 100-token prompt in the 128 bucket counts 100 rows, not 128
    t100 = work.products_seconds(c["shape"], c["quant"], [100])
    t128 = work.products_seconds(c["shape"], c["quant"], [128])
    assert t100 < t128
    assert work.products_seconds(c["shape"], c["quant"], [100, 100, 8]) == \
        pytest.approx(2 * t100 + t8)


def test_model_flops():
    s = CONF["mistral-7b-v0.3"]["shape"]
    P = 32 * LAYER["mistral-7b-v0.3"] + HEAD["mistral-7b-v0.3"]
    # prompt of 3: 3 tokens of linears, causal attention over 1 + 2 + 3 keys
    assert work.prefill_flops(s, 3) == 2 * P * 3 + 4 * 32 * 32 * 128 * 6
    # two tokens at positions 10 and 11 attend 11 and 12 keys
    assert work.decode_flops(s, 2, 23) == 2 * P * 2 + 4 * 32 * 32 * 128 * 23


def _run(**kw):
    c = CONF["mistral-7b-v0.3"]
    base = dict(cell={"root": str(bench.ROOT)}, shape=c["shape"],
                quant=c["quant"], n_slots=8, buckets=(64, 128, 256, 512),
                traffic={"chunk_steps": 4})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_roofline_readers_use_real_rows_and_group_time():
    c = CONF["mistral-7b-v0.3"]
    it = dict(traced=True, prefills=[100, 300], decode_rows=[8, 8, 7],
              decode_keys=0, tokens=0)
    run = _run(iterations=[it, dict(it, traced=False)],
               trace={"group_s": {"tile": 0.01, "grouped_gemv": 0.02}})
    tile = bench.module(bench.ROOT, "metrics", "tile_roofline.serve").read(run)
    assert tile == pytest.approx(
        100 * work.products_seconds(c["shape"], c["quant"], [100]) / 0.01)
    gemv = bench.module(bench.ROOT, "metrics", "gemv_roofline.serve").read(run)
    assert gemv == pytest.approx(
        100 * work.products_seconds(c["shape"], c["quant"], [8, 8, 7]) / 0.02)
    occ = bench.module(bench.ROOT, "metrics", "slot_occupancy.serve").read(run)
    assert occ == pytest.approx(100 * 2 * 23 / (2 * 4 * 8))
    # at 32 slots decode is the tile group's, and the GEMV metric is silent
    run32 = _run(n_slots=32, iterations=[it], trace=run.trace)
    assert bench.module(bench.ROOT, "metrics",
                        "gemv_roofline.serve").read(run32) is None
    assert bench.module(bench.ROOT, "metrics", "tile_roofline.serve").read(
        run32) == pytest.approx(100 * work.products_seconds(
            c["shape"], c["quant"], [100, 8, 8, 7]) / 0.01)
