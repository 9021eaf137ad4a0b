"""The sparse (Qwen2-MoE) cell's files: a tiny copy of its configuration
runs through ``loops/closed_chat_moe.py`` on the CPU, its reference
agrees with the port's, and its reckoning of work matches the published
model."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, make_tiny_root
from perfbench import bench
from perfbench.work import moe as work

#: the port's ``tiny-qwen2-moe`` registry entry in a configuration's keys
TINY_MOE_SHAPE = dict(
    hidden_size=256, intermediate_size=384, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    vocab_size=512, rms_norm_eps=1e-6, rope_theta=10000.0, qkv_bias=True,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
    shared_expert_intermediate_size=256, norm_topk_prob=False)


def _moe_root(tmp_path, limit=1e-3):
    root = make_tiny_root(tmp_path)
    conf = json.loads((root / "configs" / "qwen2-57b-a14b.json").read_text())
    conf.update(registry_name="tiny-qwen2-moe", shape=dict(TINY_MOE_SHAPE))
    conf["quant"]["compute_dtype"] = "float32"
    (root / "configs" / "tiny_moe.json").write_text(json.dumps(conf))
    tr = json.loads((root / "traffic" / "tiny_chat.json").read_text())
    tr["kind"] = "closed_chat_moe"
    (root / "traffic" / "tiny_chat_moe.json").write_text(json.dumps(tr))
    w = json.loads((root / "workloads" / "qwen2_57b.chat_c8.json").read_text())
    w.update(config="tiny_moe", traffic="tiny_chat_moe",
             checks={"mean_logit_gap": limit})
    (root / "workloads" / "tiny_moe.chat.json").write_text(json.dumps(w))
    return root


def _run(root, seed, control=False, traced=False):
    import time
    cell = bench.cell("tiny_moe.chat", root)
    loop = bench.module(root, "loops", cell["traffic_data"]["kind"])
    return loop.run(cell, seed, 0.6, traced, "cpu", time.perf_counter(),
                    control=control)


def test_tiny_moe_cell_runs_correct_and_reads_its_metrics(tmp_path):
    root = _moe_root(tmp_path)
    run = _run(root, 2**31 + 11)
    assert run.correct and run.attempted > 0 and not run.failed
    assert run.checks["mean_logit_gap"]["value"] <= 1e-3
    got = bench.read_metrics(run.cell["end_to_end"] + run.cell["per_layer"],
                             run, root)
    for name in ("gen_tok_s", "ttft_p95_ms", "setup_s", "moe_mfu.serve",
                 "slot_occupancy.serve"):
        assert name in got, name
    # no trace: the device readers find nothing and say so
    assert "expert_roofline.serve" not in got
    assert "dense_gemv_roofline.serve" not in got
    assert "idle_share.serve" not in got


def test_tiny_moe_control_is_judged_in_the_programs_place(tmp_path):
    run = _run(_moe_root(tmp_path), 7, control=True)
    assert run.program_checks["mean_logit_gap"]["value"] <= 1e-3
    assert run.checks["mean_logit_gap"]["value"] > 1e-3
    assert not run.correct


def test_reference_matches_the_port_reference_on_the_same_weights():
    """perfbench's reference and the port's ``models.moe_reference`` give
    the same float32 logits on one random packed tiny model."""
    from amq_tpu_torch.models import moe as tmoe
    from amq_tpu_torch.models import moe_reference
    from amq_tpu_torch.models.config import get_config
    from perfbench import model_moe
    from perfbench.reference import moe as ref
    conf = json.loads((REPO / "perfbench" / "configs" /
                       "qwen2-57b-a14b.json").read_text())
    cfg = get_config("tiny-qwen2-moe")
    net, weights = model_moe.build(cfg, TINY_MOE_SHAPE, conf["quant"],
                                   torch.Generator().manual_seed(3), "cpu")
    tok = torch.randint(0, 512, (40,), generator=torch.Generator().manual_seed(4))
    got = ref.logits_many(weights, TINY_MOE_SHAPE, [tok])[0]
    want = moe_reference.forward(tmoe.dequantized_params(net, cfg), cfg, tok)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    tail = ref.logits_many(weights, TINY_MOE_SHAPE, [tok], first=[30])[0]
    assert torch.allclose(tail, got[30:], atol=1e-5)


def test_reckoning_counts_57b_a14b_active_and_expert_weights():
    shape = json.loads((REPO / "perfbench" / "configs" /
                        "qwen2-57b-a14b.json").read_text())["shape"]
    # weights a token multiplies; with the 0.54B embedding it reads
    # 14.2B, the "A14B" of the name
    active = work.active_params(shape)
    assert 13.6e9 < active < 13.8e9
    assert 14.1e9 < active + 151936 * 3584 < 14.4e9
    quant = {"group_size": 128}
    one = work.expert_bytes(shape, quant, 4)
    assert one == pytest.approx(3 * 3584 * 2560 * (0.5 + 4 / 128))
    bits = work.layer_container_bits(
        shape, {"layer_bits_cycle": [2, 3, 4], "containers": {"3": 4}})
    assert bits[:3] == [2, 4, 4] and len(bits) == 28


def test_judge_reads_the_mean_and_widest_gap_of_the_served_tokens(
        monkeypatch):
    from perfbench.reference import moe as ref
    lg = torch.tensor([[0.0, 1.0, 3.0], [2.0, 0.0, 1.0], [0.0, 5.0, 1.0]])
    monkeypatch.setattr(ref, "logits_many", lambda *a, **k: [lg])
    out = ref.judge(None, {}, [dict(prompt=torch.tensor([7]),
                                    served=torch.tensor([2, 1, 1]))])
    assert out == {"mean_logit_gap": pytest.approx(2 / 3), "logit_gap": 2.0,
                   "tokens": 3}


def test_dense_products_reckon_attention_shared_expert_and_head():
    shape = json.loads((REPO / "perfbench" / "configs" /
                        "qwen2-57b-a14b.json").read_text())["shape"]
    quant = {"layer_bits_cycle": [2, 3, 4], "containers": {"3": 4},
             "group_size": 128, "head_bits": 8}
    H, V = 3584, 151936
    per_layer = H * (36 * 128 + H + 2 * 20480) + 20480 * H
    bits = work.layer_container_bits(shape, quant)
    want = sum(per_layer * (b / 8 + 4 / 128) for b in bits)
    want += V * H * (1 + 4 / 128)
    # x in and out in bf16 at one row, the head's logits in float32
    want += 28 * 2 * (H + 36 * 128 + 2 * H + H + 2 * 20480 + 20480 + H)
    want += 2 * H + 4 * V
    got = [b for _, b in work.dense_step_products(shape, quant, 1)]
    assert len(got) == 4 * 28 + 1
    assert sum(got) == pytest.approx(want, rel=1e-12)
    assert work.dense_products_seconds(shape, quant, [8, 8, 1]) == \
        pytest.approx(2 * work.dense_products_seconds(shape, quant, [8])
                      + work.dense_products_seconds(shape, quant, [1]))
