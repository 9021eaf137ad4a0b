"""Shared fixtures: a copy of the benchmark's folder with a tiny cell
added by files alone, as a later change would add one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny CPU runs time their windows: one thread a test process keeps them
# from contending with each other under pytest-xdist
torch.set_num_threads(1)

#: the port's ``tiny-llama`` registry entry in a configuration's keys
TINY_SHAPE = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                  vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
                  qkv_bias=False)


def make_tiny_root(tmp: Path, compute_dtype: str = "float32",
                   limit: float = 1e-3, eval_limit: float = 1e-3) -> Path:
    """A copy of ``perfbench/`` under ``tmp`` with ``configs/tiny.json``,
    the traffic mixes ``tiny_chat`` and ``tiny_eval`` and the cells
    ``tiny.chat`` and ``tiny.eval``."""
    root = tmp / "perfbench"
    shutil.copytree(REPO / "perfbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((root / "configs" / "mistral-7b-v0.3.json").read_text())
    conf["registry_name"] = "tiny-llama"
    conf["shape"] = dict(TINY_SHAPE)
    conf["quant"]["compute_dtype"] = compute_dtype
    conf["n_sample"] = 2
    (root / "configs" / "tiny.json").write_text(json.dumps(conf))
    tr = json.loads((root / "traffic" / "chat_c8.json").read_text())
    tr.update(clients=3, slots=3, max_len=256, prefill_buckets=[16, 32, 64],
              chunk_steps=4, ramp_requests=3, trace_seconds=0.3,
              check_requests=6, check_tokens_min=10,
              prompt={"median": 24, "sigma": 0.8, "clip": [4, 64]},
              output={"median": 12, "sigma": 0.7, "clip": [2, 48]})
    (root / "traffic" / "tiny_chat.json").write_text(json.dumps(tr))
    w = json.loads((root / "workloads" / "mistral7b.chat_c8.json").read_text())
    w.update(config="tiny", traffic="tiny_chat", checks={"logit_gap": limit})
    (root / "workloads" / "tiny.chat.json").write_text(json.dumps(w))
    ev = json.loads((root / "traffic" / "search_eval.json").read_text())
    ev.update(seqlen=96, archs_per_call=2, trace_seconds=0.3)
    (root / "traffic" / "tiny_eval.json").write_text(json.dumps(ev))
    w = json.loads((root / "workloads" / "qwen25_7b.search_eval.json").read_text())
    w.update(config="tiny", traffic="tiny_eval",
             checks={"loss_rel_gap": eval_limit})
    (root / "workloads" / "tiny.eval.json").write_text(json.dumps(w))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_tiny(root: Path, seed: int, seconds: float = 0.6, control=False,
             name: str = "tiny.chat", traced: bool = False):
    """One CPU run of a tiny cell through its loop (the harness's look
    for a card is skipped)."""
    import time
    from perfbench import bench
    cell = bench.cell(name, root)
    loop = bench.module(root, "loops", cell["traffic_data"]["kind"])
    return loop.run(cell, seed, seconds, traced, "cpu", time.perf_counter(),
                      control=control)
