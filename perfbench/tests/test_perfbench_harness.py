"""The harness is driven by files found by name, and ``BENCHMARK.json``
agrees with them."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO
from perfbench import bench

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_new_workload_file_is_found_without_code_edit(tiny_root):
    """A cell added as one file under ``workloads/`` (a made-up pairing of
    an existing configuration and traffic mix) resolves by name, and so do
    its loop and metrics."""
    cell = {"config": "qwen2.5-7b", "traffic": "chat_c32", "chips": 1,
            "why": "made up", "end_to_end": ["gen_tok_s", "setup_s"],
            "per_layer": ["idle_share.serve"], "checks": {"logit_gap": 1.0}}
    (tiny_root / "workloads" / "made_up.cell.json").write_text(json.dumps(cell))
    got = bench.cell("made_up.cell", tiny_root)
    assert got["config_data"]["registry_name"] == "Qwen2.5-7B"
    assert got["traffic_data"]["slots"] == 32
    assert bench.module(tiny_root, "loops", got["traffic_data"]["kind"]).run
    for name in got["end_to_end"] + got["per_layer"]:
        assert bench.module(tiny_root, "metrics", name).UNIT
    with pytest.raises(KeyError):
        bench.cell("no.such.cell", tiny_root)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_file_agrees_with_benchmark_json(metric):
    spec = next(m for m in METRICS if m["name"] == metric)
    mod = bench.module(bench.ROOT, "metrics", metric)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
        spec["unit"], spec["better"], spec["source"])
    if spec in SPEC["per_layer"]:
        assert (mod.LAYER, mod.MOVES) == (spec["layer"], spec["moves"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_file_agrees_with_benchmark_json(cell):
    spec = next(w for w in SPEC["workloads"] if w["name"] == cell)
    got = bench.cell(cell)
    assert (got["config"], got["traffic"], got["chips"], got["why"]) == (
        spec["config"], spec["traffic"], spec["chips"], spec["why"])
    for kind in ("end_to_end", "per_layer"):
        want = [m["name"] for m in SPEC[kind]
                if cell in m.get("workloads", [cell])]
        assert sorted(got[kind]) == sorted(want)
    conf = next(c for c in SPEC["configs"] if c["name"] == got["config"])
    assert conf["file"] == f"perfbench/configs/{got['config']}.json"
    assert conf["source"] == got["config_data"]["source"]
    assert conf["reduced"] == got["config_data"]["reduced"]


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_shape_is_the_port_registry_entry(conf):
    from amq_tpu_torch.models.config import get_config
    data = json.loads((bench.ROOT / "configs" / f"{conf}.json").read_text())
    s, cfg = data["shape"], get_config(data["registry_name"])
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.vocab_size,
            cfg.rms_norm_eps, cfg.rope_theta, cfg.qkv_bias,
            cfg.tie_word_embeddings, cfg.sliding_window) == (
        s["hidden_size"], s["intermediate_size"], s["num_hidden_layers"],
        s["num_attention_heads"], s["num_key_value_heads"], s["head_dim"],
        s["vocab_size"], s["rms_norm_eps"], s["rope_theta"], s["qkv_bias"],
        s["tie_word_embeddings"], s.get("sliding_window"))


def test_run_without_a_card_prints_no_result(tmp_path):
    """No CUDA device here: the command exits non-zero and prints no
    result line."""
    cmd = [sys.executable, "-m", "perfbench.run", *SPEC["command"][3:],
           "--workload", SPEC["workloads"][0]["name"], "--seed", "2147483700",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_benchmark_json_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    cells = len(SPEC["workloads"])
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= cells <= 24


@pytest.mark.parametrize("name", ["tiny.chat", "tiny.eval"])
def test_traced_run_without_device_events(tiny_root, name):
    """A traced run drives the profiler around its slice; with no device
    operation in it (the CPU), the trace is empty and the device metrics
    say nothing rather than 0."""
    from conftest import run_tiny
    run = run_tiny(tiny_root, 2**31 + 90, name=name, traced=True)
    assert run.trace is None
    assert run.correct, run.checks
    got = bench.read_metrics(run.cell["per_layer"], run, tiny_root)
    assert not any(k.startswith(("idle_share", "gemv_roofline",
                                 "tile_roofline", "flash_roofline",
                                 "dequant_roofline")) for k in got)


def test_summarize_reads_busy_union_groups_and_idle_labels():
    """Device intervals inside the slice are merged into busy time, sorted
    into kernel groups, and the gaps between them labelled by the span and
    CPU op around their middles; the rooflines' denominators add the split
    sums to their group."""
    import re
    from perfbench import trace
    ms = 1_000_000
    events = [("span", 0, 100 * ms, "perfbench.slice"),
              ("span", 0, 60 * ms, "perfbench.iteration"),
              ("cpu", 40 * ms, 55 * ms, "aten::copy_"),
              ("device", -5 * ms, 10 * ms, "qmm_grouped_kernel<4>"),
              ("device", 5 * ms, 30 * ms, "qmm_grouped_kernel<2>"),
              ("device", 30 * ms, 35 * ms, "reduce_splits_kernel"),
              ("device", 70 * ms, 80 * ms, "elementwise"),
              ("device", 150 * ms, 160 * ms, "after the slice")]
    groups = [("grouped_gemv", [re.compile("qmm_grouped")]),
              ("split_reduce", [re.compile("reduce_splits")])]
    got = trace.summarize(events, groups)
    assert got["window_s"] == pytest.approx(0.1)
    assert got["busy_s"] == pytest.approx(0.045)
    assert got["group_s"] == pytest.approx(
        {"grouped_gemv": 0.035, "split_reduce": 0.005, "other": 0.01})
    assert got["idle_s"] == pytest.approx(
        {"iteration / aten::copy_": 0.035, "outside spans / python, no op": 0.02})
    assert bench.group_seconds(got, "grouped_gemv", "split_reduce") == \
        pytest.approx(0.04)
    assert bench.group_seconds(got, "tile", "split_reduce") == 0
    assert trace.summarize(events[1:], groups) is None
