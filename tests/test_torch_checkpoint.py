"""Checkpoints and local HF directories cross between the two packages,
and the port's proxy / quantize CLIs and ``--model_path`` /
``--proxy_path`` run with ``--device cpu``.

* JAX ``save_quantized`` -> port ``load_quantized`` (f32 and bf16 meta),
  and the port's save -> JAX load: arrays equal;
* a tiny JAX ``save_hf_checkpoint`` -> port ``load_hf_params`` equal to
  the ``convert``-ed JAX ``load_hf_params``, and the port's writer -> JAX;
  the port's safetensors codec equal to the ``safetensors`` package.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models import hf as j_hf
from amq_tpu.models.config import LINEAR_NAMES
from amq_tpu.utils import checkpoint as j_ckpt

import torch

from amq_tpu_torch.cli import common as t_common
from amq_tpu_torch.cli import proxy as t_proxy_cli
from amq_tpu_torch.cli import quantize as t_quantize_cli
from amq_tpu_torch.cli import sensitivity as t_sensitivity_cli
from amq_tpu_torch.evaluation.metrics import get_bits_usage
from amq_tpu_torch.models import convert
from amq_tpu_torch.models import hf as t_hf
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.linear import QuantLinear
from amq_tpu_torch.models.transform import quantize_model as t_quantize_model
from amq_tpu_torch.utils import checkpoint as t_ckpt

from test_torch_slice import flatten_params, torch_one_thread  # noqa: F401


def _bits(a):
    """An array's bits as numpy (bf16 as uint16, packed words as uint32)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _port_leaf(params, key):
    """The port's array at a ``flatten_params`` key."""
    parts = key.split("/")
    if parts[0] == "layers":
        node, rest = params["layers"][int(parts[1])][parts[2]], parts[3:]
    else:
        node, rest = params[parts[0]], parts[1:]
    for p in rest:
        node = getattr(node, p)
    return node


def _assert_same(t_params, j_params, cfg):
    """Every array of a port dict equal (same bits, same dtype) to the JAX
    pytree's, and the same packing metadata."""
    flat, static = flatten_params(j_params, cfg)
    for key, want in flat.items():
        got, want = _bits(_port_leaf(t_params, key)), _bits(want)
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key, meta in static.items():
        qt = _port_leaf(t_params, key)
        assert (qt.nbits, qt.group_size, tuple(qt.shape), qt.superblock) == (
            meta["nbits"], meta["group_size"], tuple(meta["shape"]),
            meta["superblock"])


@pytest.fixture(scope="module")
def jmodel():
    cfg = get_config("tiny-llama")
    return cfg, init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_in_the_port(jmodel, tmp_path, meta):
    cfg, params = jmodel
    q = quantize_model(params, cfg, 3, meta_dtype=getattr(jnp, meta))
    j_ckpt.save_quantized(q, cfg, str(tmp_path / "m"),
                          extra_meta={"nbits": 3})
    got, tcfg = t_ckpt.load_quantized(str(tmp_path / "m"))
    assert tcfg.name == cfg.name
    qt = got["layers"][0]["self_attn.q_proj"].qt
    assert qt.scale.dtype == getattr(torch, meta)
    assert qt.packed.dtype == torch.int32
    _assert_same(got, j_ckpt.load_quantized(str(tmp_path / "m"))[0], cfg)
    # floats other than the stored-narrow ones take the load dtype
    wide, _ = t_ckpt.load_quantized(str(tmp_path / "m"), dtype=torch.float64)
    assert wide["embed"].dtype == torch.float64


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax(jmodel, tmp_path, meta):
    cfg, params = jmodel
    tparams = convert.params_from_flat(*flatten_params(params, cfg),
                                       num_layers=cfg.num_layers)
    tcfg = t_get_config(cfg.name)
    q = t_quantize_model(tparams, tcfg, 4, meta_dtype=getattr(torch, meta))
    # one dense linear and a bias survive the trip too
    q["layers"][1] = dict(q["layers"][1])
    q["layers"][1]["mlp.up_proj"] = tparams["layers"][1]["mlp.up_proj"]
    q["layers"][0]["self_attn.v_proj"] = QuantLinear(
        qt=q["layers"][0]["self_attn.v_proj"].qt,
        bias=torch.arange(cfg.kv_dim, dtype=torch.float32))
    t_ckpt.save_quantized(q, tcfg, str(tmp_path / "m"),
                          extra_meta={"nbits": 4})
    jq, jcfg = j_ckpt.load_quantized(str(tmp_path / "m"))
    assert jcfg.name == cfg.name
    assert isinstance(jq["layers"][1]["mlp.up_proj"], type(
        params["layers"][1]["mlp.up_proj"]))
    _assert_same(q, jq, cfg)
    with open(tmp_path / "m" / "manifest.json") as f:
        man = json.load(f)
    assert man["nbits"] == 4
    assert bool(man["nonnative_dtypes"]) == (meta == "bfloat16")


def test_hf_checkpoint_crosses_both_ways(jmodel, tmp_path):
    cfg, params = jmodel
    jpath = str(tmp_path / "tiny-llama")
    j_hf.save_hf_checkpoint(params, cfg, jpath)
    tcfg = t_hf.config_from_hf(jpath)
    assert tcfg == t_hf.config_from_hf(jpath)
    for f in ("hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "vocab_size", "rope_theta"):
        assert getattr(tcfg, f) == getattr(cfg, f)
    want = convert.params_from_flat(
        *flatten_params(j_hf.load_hf_params(jpath, cfg), cfg),
        num_layers=cfg.num_layers)
    got = t_hf.load_hf_params(jpath, tcfg)
    assert torch.equal(got["embed"], want["embed"])
    assert torch.equal(got["lm_head"].weight, want["lm_head"].weight)
    for lg, lw in zip(got["layers"], want["layers"]):
        for k in ("input_norm", "post_norm"):
            assert torch.equal(lg[k], lw[k])
        for name in LINEAR_NAMES:
            assert torch.equal(lg[name].weight, lw[name].weight)
    # the port's writer (bf16 stays bf16) read back by JAX
    tpath = str(tmp_path / "port-out")
    t_hf.save_hf_checkpoint(got, tcfg, tpath, dtype=torch.bfloat16)
    back = j_hf.load_hf_params(tpath, j_hf.config_from_hf(tpath),
                               dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(back["layers"][2]["mlp.down_proj"].weight),
        got["layers"][2]["mlp.down_proj"].weight.to(torch.bfloat16).float()
        .numpy())
    again = t_hf.load_hf_params(tpath, dtype=torch.bfloat16)
    assert again["embed"].dtype == torch.bfloat16
    assert torch.equal(again["embed"], got["embed"].to(torch.bfloat16))


def test_safetensors_codec_matches_the_library(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn((3, 5), generator=g),
               "b.bf16": torch.randn((7,), generator=g).to(torch.bfloat16),
               "c": torch.arange(12, dtype=torch.int64).reshape(2, 2, 3),
               "d": torch.randn((2, 2), generator=g).to(torch.float16),
               "e": torch.zeros((0, 4)), "f": torch.tensor(3.5)}
    ours = str(tmp_path / "ours.safetensors")
    theirs = str(tmp_path / "theirs.safetensors")
    t_hf.write_safetensors(tensors, ours)
    st.save_file(tensors, theirs)
    for path in (ours, theirs):
        for reader in (t_hf.read_safetensors, st.load_file):
            got = reader(path)
            assert set(got) == set(tensors)
            for k, v in tensors.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_dummy_tokenizer_loads(tmp_path):
    pytest.importorskip("transformers")
    t_hf.save_dummy_tokenizer(str(tmp_path), 64)
    tok = t_hf.load_tokenizer(str(tmp_path))
    assert list(tok("w1 w5 w63").input_ids) == [1, 5, 63]


def test_model_path_and_proxy_path_on_cpu(jmodel, tmp_path):
    """``--model_path`` loads a local HF directory; the proxy CLI writes
    proxies the sensitivity CLI reads with ``--proxy_path`` (the same
    table as quantizing in-process)."""
    cfg, params = jmodel
    path = str(tmp_path / "tiny-hf")
    j_hf.save_hf_checkpoint(params, cfg, path)
    args = t_common.base_parser("t").parse_args(
        ["--model_path", path, "--device", "cpu"])
    tcfg, tparams = t_common.load_model(args)
    assert tcfg.name == "tiny-hf" and tparams["embed"].dtype == torch.bfloat16
    with pytest.raises(SystemExit, match="no checkpoint"):
        t_common.load_model(t_common.base_parser("t").parse_args(
            ["--model_path", str(tmp_path / "absent"), "--device", "cpu"]))

    base = ["--model_path", path, "--device", "cpu", "--n_sample", "2",
            "--seqlen", "32", "--batch_size", "2", "--compute_dtype",
            "float32", "--dataset", "synthetic", "--synthetic"]
    out = t_proxy_cli.main(base + ["--save_path", str(tmp_path / "px")])
    assert [os.path.basename(p) for p in out["paths"]] == [
        f"tiny-hf_{b}bit_128gs_1axis" for b in (2, 3, 4)]
    for b, p in zip((2, 3, 4), out["paths"]):
        got, gcfg = t_ckpt.load_quantized(p)
        want = t_quantize_model(tparams, tcfg, b, meta_dtype=torch.bfloat16)
        assert gcfg.name == "tiny-hf"
        for name in LINEAR_NAMES:
            g, w = got["layers"][1][name].qt, want["layers"][1][name].qt
            assert g.scale.dtype == torch.bfloat16
            assert torch.equal(g.packed, w.packed)
            assert torch.equal(g.scale, w.scale)
            assert torch.equal(g.zero, w.zero)
    inproc = t_sensitivity_cli.main(base + ["--save_path",
                                            str(tmp_path / "s1")])
    loaded = t_sensitivity_cli.main(base + [
        "--proxy_path", str(tmp_path / "px"), "--save_path",
        str(tmp_path / "s2")])
    assert loaded["table"]["loss"] == pytest.approx(inproc["table"]["loss"],
                                                    rel=1e-6, abs=1e-9)


def _archive(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arch = {"linear": {l: rng.choice([2, 3, 4], cfg.num_layers).tolist()
                           for l in LINEAR_NAMES}}
        out.append([arch, float(rng.uniform(0.1, 1.0)),
                    get_bits_usage(arch, cfg.topology())])
    return out


@pytest.mark.parametrize("method", ["fp16", "hqq", "gptq", "awq", "owq"])
def test_quantize_cli_on_cpu(tmp_path, method):
    cfg = t_get_config("tiny-llama")
    archive = _archive(cfg, 12, 4)
    load = tmp_path / "iter_1.stats"
    load.write_text(json.dumps({"archive": archive[:8],
                                "candidates": archive[8:]}))
    target = float(np.median([b for _, _, b in archive]))
    res = t_quantize_cli.main([
        "--model_name", "tiny-llama", "--synthetic", "--device", "cpu",
        "--load", str(load), "--method", method, "--target_bits",
        str(target + (0.1 if method == "owq" else 0.0)),
        "--target_bits_offset", "0.5", "--eval_dataset", "synthetic",
        "--n_sample", "1", "--seqlen", "64", "--batch_size", "2",
        "--compute_dtype", "float32", "--save_path", str(tmp_path)])
    assert len(res) == 1 and np.isfinite(res[0]["ppl"]["synthetic"])
    stages = res[0]["stage_s"]
    assert stages["perplexity"] > 0 and stages["realization"] >= 0
    if method in ("gptq", "owq"):
        assert {"calibration", "hessians", "quantization",
                "propagation"} <= set(stages)
    with open(tmp_path / f"{method}_results.json") as f:
        assert json.load(f)[0]["method"] == method
