"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback at its entry points."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PORT = Path(__file__).resolve().parent.parent / "amq_tpu_torch"

_MODULES = ("amq_tpu_torch.serving.engine", "amq_tpu_torch.serving.benchmark",
            "amq_tpu_torch.cli.speed_benchmark", "amq_tpu_torch.models.convert",
            "amq_tpu_torch.ops", "amq_tpu_torch.cli.sensitivity",
            "amq_tpu_torch.cli.search", "amq_tpu_torch.evaluation",
            "amq_tpu_torch.evaluation.sensitivity", "amq_tpu_torch.search",
            "amq_tpu_torch.search.decision", "amq_tpu_torch.predictor")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in _MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' "
          "or m.startswith('jax.') or m == 'amq_tpu' "
          "or m.startswith('amq_tpu.'))\n"
          "assert not bad, bad\n"
          "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_source_names_no_jax_module():
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
    jax_pkg = re.compile(r"\bamq_tpu\b(?!_torch)")
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not jax_import.search(text), f
        assert not jax_pkg.search(text), f


def test_entry_points_refuse_hidden_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CUDA default is valid here")
    from amq_tpu_torch.cli import common, speed_benchmark
    from amq_tpu_torch.core.device import resolve_device
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.engine import Engine

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params={}, cfg=get_config("tiny-llama"))
    args = common.base_parser("t").parse_args(["--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        common.load_model(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        speed_benchmark.main(["--synthetic", "--modes", "TPS"])
    assert resolve_device("cpu").type == "cpu"

    from amq_tpu_torch.cli import search, sensitivity
    from amq_tpu_torch.evaluation import Evaluator
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(get_config("tiny-llama"), dense_params={})
    with pytest.raises(RuntimeError, match="CUDA"):
        sensitivity.main(["--synthetic"])
    sens = tmp_path / "sens.json"
    sens.write_text('{"loss": {"0.self_attn.q_proj": 0.5}}')
    with pytest.raises(RuntimeError, match="CUDA"):
        search.main(["--synthetic", "--sensitivity_json", str(sens)])


def test_benchmark_refuses_cpu_engine():
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    from amq_tpu_torch.serving.engine import Engine

    eng = Engine(params={}, cfg=get_config("tiny-llama"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_speed(eng, "TPS")


def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    """A wrapper given a non-CPU tensor launches its kernel or raises: with
    the plain versions replaced by a tripwire, a meta-device call raises
    and the tripwire stays untouched."""
    from amq_tpu_torch.ops import decode_attention as da
    from amq_tpu_torch.ops import flash_attention as fa
    from amq_tpu_torch.ops import quant_matmul as qm

    def tripwire(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(qm, "qmm_plain", tripwire)
    monkeypatch.setattr(da, "decode_attention_plain", tripwire)
    monkeypatch.setattr(fa, "flash_attention_plain", tripwire)
    x = torch.empty((1, 128), device="meta")
    packed = torch.empty((1, 16, 128), dtype=torch.int32, device="meta")
    meta = torch.empty((1, 1, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        qm.quant_matmul_indexed(x, packed, meta, meta, 0, nbits=4,
                                group_size=128, shape=(128, 128),
                                superblock=128)
    q = torch.empty((1, 2, 1, 64), device="meta")
    cache = torch.empty((1, 1, 2, 8, 64), device="meta")
    kn = torch.empty((1, 2, 64), device="meta")
    offs = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        da.decode_attention_indexed(q, cache, cache, kn, kn, offs, 0)
    qf = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(qf, qf, qf, 0)


def test_model_attention_never_reaches_plain_flash_off_cpu(monkeypatch):
    """In the flash regime a non-CPU tensor goes to the kernel wrapper (the
    meta device has no kernel, so it raises there), never to the plain
    flash version, SDPA or the einsum path."""
    from amq_tpu_torch.models import llama
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.ops import flash_attention as fa

    def tripwire(*a, **k):
        raise AssertionError("plain path reached")

    monkeypatch.setattr(fa, "flash_attention_plain", tripwire)
    monkeypatch.setattr(llama, "_attention", tripwire)
    monkeypatch.setattr(llama, "_attention_split", tripwire)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        tripwire)
    monkeypatch.setattr(llama, "_flash_ok", lambda S, T, cfg, device: (
        S >= 128 and S % 64 == 0 and torch.device(device).type != "cpu"
        and llama._FLASH_KERNEL))
    cfg = get_config("tiny-llama")
    B, S, hd = 1, 128, cfg.head_dim_
    q = torch.empty((B, S, cfg.num_heads, hd), device="meta")
    kv = torch.empty((B, cfg.num_kv_heads, S, hd), device="meta")
    off = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        llama.attention(q, kv, kv, None, off, S, S, cfg, torch.float32)
    with pytest.raises(ValueError, match="no kernel for device"):
        llama.attention_append(q, kv, kv, kv, kv, off, S, S, cfg,
                               torch.float32)
