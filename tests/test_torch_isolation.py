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
            "amq_tpu_torch.ops")


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


def test_entry_points_refuse_hidden_cpu():
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
    from amq_tpu_torch.ops import quant_matmul as qm

    def tripwire(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(qm, "qmm_plain", tripwire)
    monkeypatch.setattr(da, "decode_attention_plain", tripwire)
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
