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
            "amq_tpu_torch.search.decision", "amq_tpu_torch.predictor",
            "amq_tpu_torch.serving", "amq_tpu_torch.serving.batched",
            "amq_tpu_torch.serving.speculative", "amq_tpu_torch.native",
            "amq_tpu_torch.utils.profiling", "amq_tpu_torch.probes.chain",
            "amq_tpu_torch.probes.kernel_attrib",
            "amq_tpu_torch.probes.pipelined_gemv",
            "amq_tpu_torch.probes.kernel_roofline",
            "amq_tpu_torch.probes.profile_window",
            "amq_tpu_torch.core.pseudo", "amq_tpu_torch.core.lora",
            "amq_tpu_torch.utils.checkpoint", "amq_tpu_torch.models.hf",
            "amq_tpu_torch.quantization", "amq_tpu_torch.quantization.calib",
            "amq_tpu_torch.quantization.gptq",
            "amq_tpu_torch.quantization.awq",
            "amq_tpu_torch.quantization.owq",
            "amq_tpu_torch.quantization.api", "amq_tpu_torch.cli.proxy",
            "amq_tpu_torch.cli.quantize", "amq_tpu_torch.parallel",
            "amq_tpu_torch.parallel.comm", "amq_tpu_torch.parallel.multihost",
            "amq_tpu_torch.parallel.tp", "amq_tpu_torch.parallel.tp_stacked",
            "amq_tpu_torch.parallel.pp", "amq_tpu_torch.parallel.launch",
            "amq_tpu_torch.serving.dp")


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
    files = [f for ext in ("py", "cu", "cuh", "cpp")
             for f in sorted(PORT.rglob(f"*.{ext}"))]
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
    with pytest.raises(RuntimeError, match="CUDA"):
        speed_benchmark.main(["--synthetic", "--modes", "CONTINUOUS"])
    assert resolve_device("cpu").type == "cpu"

    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.benchmark import benchmark_continuous
    cfg = get_config("tiny-llama")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotEngine(model={}, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_continuous({}, cfg)
    # SpeculativeEngine decodes on its target Engine's device: the card
    from amq_tpu_torch.serving.speculative import SpeculativeEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeEngine(Engine(params={}, cfg=cfg), draft_params={})

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

    from amq_tpu_torch.cli import proxy, quantize
    with pytest.raises(RuntimeError, match="CUDA"):
        proxy.main(["--synthetic", "--save_path", str(tmp_path / "p")])
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(get_config("tiny-llama"), dense_params={}, search=False,
                  quantize_fn=lambda *a: a[0])
    stats = tmp_path / "iter_1.stats"
    stats.write_text('{"archive": [], "candidates": []}')
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize.main(["--synthetic", "--load", str(stats)])

    from amq_tpu_torch.parallel import launch, tp_stacked
    from amq_tpu_torch.serving.dp import DPSlotEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        tp_stacked.make_tp_engine(cfg, None, 1, model={}, graphs=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DPSlotEngine(model={}, cfg=cfg, group=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main([])
    # the rank programs resolve their device as the engines do
    for run, args in ((launch.tp_stacked_run, ([], (2,), cfg, [[0]])),
                      (launch.tp_run, ({}, cfg, [[0]])),
                      (launch.pp_run, ({}, cfg, [[0]])),
                      (launch.dp_serving_run, ({}, cfg, [[0]], 1)),
                      (launch.dp_eval_run, (cfg, {}, {}, []))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(0, 1, *args)
    with pytest.raises(RuntimeError, match="CUDA"):
        speed_benchmark.main(["--synthetic", "--method", "owq"])


def test_benchmark_refuses_cpu_engine():
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    from amq_tpu_torch.serving.engine import Engine

    from amq_tpu_torch.serving.benchmark import benchmark_continuous
    eng = Engine(params={}, cfg=get_config("tiny-llama"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_speed(eng, "TPS")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_continuous({}, get_config("tiny-llama"), device="cpu")


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


def test_dequantize_and_grouped_head_never_take_plain_versions(monkeypatch):
    """dequantize_kn and an 8-bit bf16 head call, given non-CPU tensors,
    launch their kernels or raise: with the plain versions replaced by
    tripwires, meta-device calls raise and the tripwires stay untouched."""
    from amq_tpu_torch.core import quantize as tq
    from amq_tpu_torch.ops import dequant as dq
    from amq_tpu_torch.ops import quant_matmul as qm

    def tripwire(*a, **k):
        raise AssertionError("plain version reached")

    for mod, name in ((dq, "dequantize_kn_plain"), (qm, "qmm_plain"),
                      (qm, "qmm_grouped_plain")):
        monkeypatch.setattr(mod, name, tripwire)
    qt = tq.QuantizedTensor(
        packed=torch.empty((256, 256), dtype=torch.int32, device="meta"),
        scale=torch.empty((8, 256), dtype=torch.bfloat16, device="meta"),
        zero=torch.empty((8, 256), dtype=torch.bfloat16, device="meta"),
        nbits=8, group_size=128, shape=(256, 1024), superblock=1024)
    with pytest.raises(ValueError, match="no kernel for device"):
        dq.dequantize_kn(qt, torch.bfloat16)
    x = torch.empty((1, 1024), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        qm.quant_matmul(x, qt, out_dtype=torch.float32)


def test_plain_side_dequantizes_through_the_plain_version(monkeypatch):
    """The dequantize-then-matmul routes take the kernel wrapper, and
    inside ``forward_kernels(False)`` (the plain side of a kernel-vs-plain
    comparison) the plain version; the plain versions of the matmul
    kernels never reach the dequantization kernel."""
    from amq_tpu_torch.core import quantize as tq
    from amq_tpu_torch.models import linear, llama
    from amq_tpu_torch.ops import dequant as dq
    from amq_tpu_torch.ops import quant_matmul as qm

    calls = []
    monkeypatch.setattr(dq, "dequantize_kn",
                        lambda qt, dt: calls.append(dt) or tq.dequantize_kn(qt, dt))
    W = torch.randn((64, 256), generator=torch.Generator().manual_seed(0))
    qt = tq.quantize(W, nbits=4)
    want = tq.dequantize_kn(qt, torch.float32)
    assert torch.equal(linear.dequantize_weight(qt, torch.float32), want)
    assert calls == [torch.float32]
    with llama.forward_kernels(False):
        assert torch.equal(linear.dequantize_weight(qt, torch.float32), want)
    assert calls == [torch.float32]
    assert linear._DEQUANT_KERNEL and llama._FLASH_KERNEL
    x = torch.randn((2, 256), generator=torch.Generator().manual_seed(1))
    qm.qmm_plain(x, qt.packed, qt.scale, qt.zero, nbits=4, group_size=128,
                 shape=(64, 256), superblock=qt.superblock,
                 out_dtype=torch.float32)
    assert calls == [torch.float32]


def test_decode_switch_wrappers_never_take_plain_versions(monkeypatch):
    """The pipelined GEMVs and the one-launch MLP, given a non-CPU tensor,
    launch or raise: with their plain versions (and the separate kernels
    the MLP could fall back to) replaced by tripwires, meta-device calls
    raise in the wrappers and the tripwires stay untouched."""
    from amq_tpu_torch.ops import quant_matmul as qm

    def tripwire(*a, **k):
        raise AssertionError("plain version or fallback reached")

    for name in ("qmm_plain", "qmm_mlp_plain", "swiglu_plain",
                 "quant_matmul_indexed", "quant_matmul_swiglu_indexed"):
        monkeypatch.setattr(qm, name, tripwire)
    x = torch.empty((1, 1024), dtype=torch.bfloat16, device="meta")
    packed = torch.empty((1, 128, 256), dtype=torch.int32, device="meta")
    meta = torch.empty((1, 8, 256), dtype=torch.bfloat16, device="meta")
    kw = dict(nbits=4, group_size=128, shape=(256, 1024), superblock=1024)
    with pytest.raises(ValueError, match="no kernel for device"):
        qm.quant_matmul_indexed_pipe(x, packed, meta, meta, 0, **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        qm.quant_matmul_swiglu_indexed_pipe(x, x, packed, meta, meta, 0, **kw)
    gu = torch.empty((1, 128, 2048), dtype=torch.int32, device="meta")
    gu_meta = torch.empty((1, 8, 2048), dtype=torch.bfloat16, device="meta")
    dn = torch.empty((1, 128, 1024), dtype=torch.int32, device="meta")
    dn_meta = torch.empty((1, 8, 1024), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        qm.quant_matmul_mlp_indexed(x, gu, gu_meta, gu_meta, dn, dn_meta,
                                    dn_meta, 0, nbits=4, group_size=128,
                                    gu_shape=(2048, 1024),
                                    d_shape=(1024, 1024), superblock=1024)


def test_decode_switches_route_and_restore(monkeypatch):
    """decode_switches sets the JAX package's two switches in-process and
    restores them; under AMQ_PIPE a qualifying call goes to the pipelined
    wrappers, and the MLP routing declines on the CPU."""
    from amq_tpu_torch.models import stacked
    from amq_tpu_torch.ops import quant_matmul as qm
    monkeypatch.delenv("AMQ_MLP_KERNEL", raising=False)
    monkeypatch.setattr(qm, "_PIPE_DEFAULT", 0)
    routed = []
    for name in ("quant_matmul_indexed_pipe",
                 "quant_matmul_swiglu_indexed_pipe"):
        monkeypatch.setattr(qm, name, lambda *a, _n=name, **k: routed.append(_n))
    x = torch.empty((4, 1024), dtype=torch.bfloat16)
    packed = torch.empty((1, 128, 256), dtype=torch.int32)
    kw = dict(nbits=4, group_size=128, shape=(256, 1024), superblock=1024)
    with stacked.decode_switches(pipe=True, mlp=True):
        assert qm._PIPE_DEFAULT == 1
        layer = (packed[0], packed[0], packed[0])
        assert qm._pipe_applies(x, *layer, 4, 128, 1024)
        assert not qm._pipe_applies(x, *layer, 4, 128, 128)      # T = 1
        assert not qm._pipe_applies(x.float(), *layer, 4, 128, 1024)
        assert not qm._pipe_applies(torch.empty((9, 1024), dtype=torch.bfloat16),
                                    *layer, 4, 128, 1024)
        qm.quant_matmul_indexed(x, packed, packed, packed, 0, **kw)
        qm.quant_matmul_swiglu_indexed(x, x, packed, packed, packed, 0, **kw)
        assert routed == ["quant_matmul_indexed_pipe",
                          "quant_matmul_swiglu_indexed_pipe"]
        assert stacked.os.environ["AMQ_MLP_KERNEL"] == "1"
        assert stacked._apply_mlp_merged(None, 0, x, torch.bfloat16, 0) is None
    assert qm._PIPE_DEFAULT == 0
    assert "AMQ_MLP_KERNEL" not in stacked.os.environ


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
