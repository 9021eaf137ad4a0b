"""The port's search-evaluation slice held to the JAX package on the CPU.

tiny-llama in float32 on both sides: JAX draws the dense parameters and
``models.convert`` carries them across; each side quantizes its own
proxies (bf16 scale/zero) and builds its own evaluator.  Dense logits,
arch losses, the sensitivity table (suffix and naive), the JSD forms,
bits usage, synthetic tokens and the corpus loaders are compared.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import datasets

from amq_tpu.evaluation import Evaluator as JEvaluator
from amq_tpu.evaluation import data as j_data
from amq_tpu.evaluation import metrics as j_metrics
from amq_tpu.evaluation.sensitivity import linear_sensitivity as j_sensitivity
from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models import hf as hf_mod
from amq_tpu.models import stacked as jst
from amq_tpu.models.config import LINEAR_NAMES, cycled_arch

import torch

from amq_tpu_torch.evaluation import Evaluator as TEvaluator
from amq_tpu_torch.evaluation import data as t_data
from amq_tpu_torch.evaluation import metrics as t_metrics
from amq_tpu_torch.evaluation.sensitivity import (SuffixArchEvaluator,
                                                  linear_sensitivity)
from amq_tpu_torch.models import convert
from amq_tpu_torch.models import stacked as tst
from amq_tpu_torch.models.config import get_config as t_get_config

from test_torch_slice import flatten_params, torch_one_thread  # noqa: F401

BITS = (2, 3, 4)


def _uniform(L, bits):
    return {"linear": {l: [bits] * L for l in LINEAR_NAMES}}


@pytest.fixture(scope="module")
def both():
    cfg = get_config("tiny-llama")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_flat(*flatten_params(params, cfg),
                                       num_layers=cfg.num_layers)
    # 3 samples at batch 2: the last loss batch is padded
    toks = j_data.synthetic_tokens(cfg.vocab_size, n_sample=3, seqlen=64,
                                   seed=0)
    jev = JEvaluator(cfg, dense_params=params, datasets={"s": toks},
                     batch_size=2, compute_dtype=jnp.float32)
    tev = TEvaluator(t_get_config(cfg.name), dense_params=tparams,
                     datasets={"s": toks}, batch_size=2,
                     compute_dtype=torch.float32, device="cpu")
    return cfg, params, jev, tev


def test_dense_logits_match(both):
    _, _, jev, tev = both
    got = tev.dense_logits["s"]
    want = jev.dense_logits["s"]
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    # both round f32 logits through bf16 to fp16: one bf16 step (2^-8 of
    # the value) apart where the two f32 sums straddle a rounding point
    got = got.float().numpy()
    want = want.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-3)
    assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("kind", ["all2", "all4", "cycled"])
def test_eval_losses_match(both, kind):
    cfg, _, jev, tev = both
    L = cfg.num_layers
    arch = {"all2": _uniform(L, 2), "all4": _uniform(L, 4),
            "cycled": cycled_arch(L, BITS)}[kind]
    (jm, jb), (tm, tb) = jev.eval(arch), tev.eval(arch)
    assert tb == jb
    # f32 forwards on both sides, sums in other orders: the JSD is a
    # difference of nearby log-probabilities, so hold it relative 1e-3
    assert tm["s"] == pytest.approx(jm["s"], rel=1e-3, abs=1e-6)


def test_eval_many_matches_eval(both):
    cfg, _, _, tev = both
    rng = np.random.default_rng(5)
    archs = [{"linear": {l: [int(b) for b in rng.choice(BITS, cfg.num_layers)]
                         for l in LINEAR_NAMES}} for _ in range(3)]
    many = tev.eval_many(archs)
    for a, got in zip(archs, many):
        assert got == tev.eval(a)


def test_suffix_arch_evaluator_matches_eval(both):
    cfg, _, _, tev = both
    arch = cycled_arch(cfg.num_layers, BITS)
    m, b = SuffixArchEvaluator(tev, "s").eval(arch)
    want_m, want_b = tev.eval(arch)
    assert b == want_b
    assert m["s"] == pytest.approx(want_m["s"], rel=1e-5, abs=1e-8)


def test_sensitivity_suffix_naive_and_jax_agree(both):
    _, _, jev, tev = both
    suffix = linear_sensitivity(tev, "s")
    naive = linear_sensitivity(tev, "s", suffix=False)
    want = j_sensitivity(jev, "s")
    assert set(suffix) == set(want) and suffix["linear"] == want["linear"]
    assert suffix["n_block"] == want["n_block"] and len(suffix["loss"]) == 28
    for k, v in want["loss"].items():
        assert suffix["loss"][k] == pytest.approx(naive["loss"][k],
                                                  rel=1e-5, abs=1e-8)
        assert suffix["loss"][k] == pytest.approx(v, rel=1e-3, abs=1e-6)


def test_switch_model_matches_jax_stack(both):
    """``stack_proxies(fuse="never")`` over the three carried-across JAX
    proxies builds the JAX switch model's arrays and selectors."""
    cfg, params, _, _ = both
    proxies = [quantize_model(params, cfg, b, meta_dtype=jnp.bfloat16)
               for b in BITS]
    jm = jst.stack_proxies(proxies, BITS, fuse="never")
    tm = tst.stack_proxies(
        [convert.params_from_flat(*flatten_params(p, cfg),
                                  num_layers=cfg.num_layers) for p in proxies],
        BITS, fuse="never")
    assert set(tm.sites) == set(jm.sites) == set(LINEAR_NAMES)
    for name, stacks in jm.sites.items():
        for js, ts in zip(stacks, tm.sites[name]):
            np.testing.assert_array_equal(ts.packed.numpy().view(np.uint32),
                                          np.asarray(js.packed))
            np.testing.assert_array_equal(
                ts.scale.float().numpy(), np.asarray(js.scale.astype(jnp.float32)))
    arch = cycled_arch(cfg.num_layers, BITS)
    jm2, tm2 = jst.set_arch(jm, arch), tst.set_arch(tm, arch)
    for name in jm.sites:
        assert tm2.select[name] == np.asarray(jm2.select[name]).tolist()
    # layer bounds: the baseline advanced block by block equals the full
    # forward, and the suffix from block 0 equals the whole model
    tcfg = t_get_config(cfg.name)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    x = tm2.embed[toks].float()
    full, _ = tst.forward_stacked(tm2, tcfg, toks, compute_dtype=torch.float32)
    suffix = tst.forward_stacked_suffix(tm2, tcfg, x, 0,
                                        compute_dtype=torch.float32)
    torch.testing.assert_close(suffix, full, rtol=0, atol=0)
    y = x
    for b in range(cfg.num_layers):
        y = tst.scan_layers(tm2, tcfg, y, compute_dtype=torch.float32,
                            start_layer=b, stop_layer=b + 1)[0]
    whole = tst.scan_layers(tm2, tcfg, x, compute_dtype=torch.float32)[0]
    torch.testing.assert_close(y, whole, rtol=0, atol=0)
    jsuf = jst.forward_stacked_suffix(jm2, cfg, jnp.asarray(x.numpy()),
                                      jnp.int32(2), compute_dtype=jnp.float32)
    tsuf = tst.forward_stacked_suffix(tm2, tcfg, x, 2,
                                      compute_dtype=torch.float32)
    np.testing.assert_allclose(tsuf.numpy(), np.asarray(jsuf), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="fused"):
        tst.set_arch(tst.stack_proxies(
            [convert.params_from_flat(*flatten_params(p, cfg),
                                      num_layers=cfg.num_layers)
             for p in proxies], BITS), arch)


@pytest.mark.parametrize("S,chunk", [(65, 16), (64, 16), (300, 256), (8, 16)])
def test_jsd_chunked_fused_and_jax_agree(S, chunk):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(3, S, 37)).astype(np.float32)
    q = rng.normal(size=(3, S, 37)).astype(np.float16)
    want = np.asarray(j_metrics.jsd_shifted_per_sample(jnp.asarray(p),
                                                       jnp.asarray(q)))
    fused = t_metrics.jsd_shifted_per_sample(torch.from_numpy(p),
                                             torch.from_numpy(q))
    chunked = t_metrics.jsd_shifted_per_sample(torch.from_numpy(p),
                                               torch.from_numpy(q), chunk=chunk)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5, atol=1e-7)
    assert float(t_metrics.jsd_shifted(torch.from_numpy(p),
                                       torch.from_numpy(p))) == pytest.approx(
        0.0, abs=1e-6)


def test_cross_entropy_and_summaries_match():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 31)).astype(np.float32)
    toks = rng.integers(0, 31, (2, 9)).astype(np.int32)
    want = np.asarray(j_metrics.cross_entropy_shifted_per_sample(
        jnp.asarray(logits), jnp.asarray(toks)))
    got = t_metrics.cross_entropy_shifted_per_sample(torch.from_numpy(logits),
                                                     torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(t_metrics.cross_entropy_shifted(
        torch.from_numpy(logits), torch.from_numpy(toks))) == pytest.approx(
        float(j_metrics.cross_entropy_shifted(jnp.asarray(logits),
                                              jnp.asarray(toks))), rel=1e-6)
    losses = [0.5, 1.25, 2.0]
    assert t_metrics.ppl_from_losses(losses) == j_metrics.ppl_from_losses(losses)
    assert t_metrics.loss_from_losses(losses) == j_metrics.loss_from_losses(losses)
    pred, tgt = rng.normal(size=20), rng.normal(size=20)
    assert t_metrics.get_correlation(pred, tgt) == j_metrics.get_correlation(
        pred, tgt)


@pytest.mark.parametrize("name", ["tiny-llama", "Llama-2-7b-hf"])
def test_bits_usage_and_synthetic_tokens_exact(name):
    cfg = get_config(name)
    rng = np.random.default_rng(7)
    for _ in range(3):
        arch = {"linear": {l: [int(b) for b in rng.choice(BITS, cfg.num_layers)]
                           for l in LINEAR_NAMES}}
        for g in (128, -1):
            assert t_metrics.get_bits_usage(arch, t_get_config(name).topology(),
                                            g) == \
                j_metrics.get_bits_usage(arch, cfg.topology(), g)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            t_data.synthetic_tokens(cfg.vocab_size, 4, 96, seed),
            j_data.synthetic_tokens(cfg.vocab_size, 4, 96, seed))


# -- corpus loaders against tests/test_data_golden.py's goldens ------------

CORPUS = os.path.join(os.path.dirname(__file__), "data", "mini_corpus.txt")
WT2_TEST = ([312, 342, 448, 289, 388, 416, 113, 28, 150, 143, 436, 456],
            [165, 78, 441, 3], 1541192)
TRAIN = ([350, 115, 34, 150, 249, 437, 469, 117, 403, 259, 329, 234],
         [462, 343, 466, 351], 133038)
PILEVAL = ([457, 416, 53, 284, 475, 334, 279, 425, 298, 203, 457, 451],
           [199, 109, 70, 254], 324298)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    hf_mod.save_dummy_tokenizer(str(d), 512)
    return hf_mod.load_tokenizer(str(d))


@pytest.fixture()
def hub(monkeypatch):
    lines = open(CORPUS).read().splitlines()
    ds = datasets.Dataset.from_dict({"text": lines})
    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **k: ds)


def _golden(t, shape, golden):
    first, last, total = golden
    assert t.shape == shape and t.dtype == np.int32
    assert t[0, :12].tolist() == first
    assert t[-1, -4:].tolist() == last
    assert int(t.sum()) == total


@pytest.mark.parametrize("loader", ["wikitext2", "c4", "local", "pileval"])
def test_loaders_match_goldens(tok, hub, loader):
    if loader == "wikitext2":
        _golden(t_data.get_wikitext2(tok, seqlen=256), (24, 256), WT2_TEST)
        _golden(t_data.get_wikitext2(tok, seqlen=256, train=True, seed=0,
                                     n_sample=32), (2, 256), TRAIN)
    elif loader == "c4":
        _golden(t_data.get_c4(tok, seqlen=256, train=True, seed=0,
                              n_sample=32), (2, 256), TRAIN)
        _golden(t_data.get_c4(tok, seqlen=256), (24, 256), WT2_TEST)
    elif loader == "local":
        _golden(t_data.get_loader("local:" + CORPUS, tok, train=False,
                                  seqlen=256), (24, 256), WT2_TEST)
        _golden(t_data.get_local_text(CORPUS, tok, seqlen=256, train=True,
                                      seed=0, n_sample=32), (2, 256), TRAIN)
    else:
        _golden(t_data.get_pileval(tok, block_size=256, n_lines=64),
                (5, 256), PILEVAL)


def test_cli_slice_on_cpu(tmp_path):
    """sensitivity -> search through the port's CLIs at tiny size on the
    CPU: the JAX CLIs' file names and schemas."""
    from amq_tpu_torch.cli import search, sensitivity
    common = ["--synthetic", "--device", "cpu", "--n_sample", "3",
              "--seqlen", "64", "--batch_size", "2",
              "--compute_dtype", "float32"]
    sens = sensitivity.main(common + ["--save_path", str(tmp_path / "sens")])
    assert os.path.basename(sens["path"]) == \
        "tiny-llama_dataset_wikitext2_n_sample_3_seqlen_64.json"
    table = json.load(open(sens["path"]))
    assert set(table) == {"loss", "time_elapsed", "dataset", "n_block",
                          "linear"}
    assert len(table["loss"]) == 28
    assert all(np.isfinite(v) and v >= 0 for v in table["loss"].values())
    out = search.main(common + [
        "--sensitivity_json", sens["path"], "--iterations", "2",
        "--n_doe", "8", "--n_iter", "4", "--ga_pop_size", "16",
        "--subset_pop_size", "8", "--save_iter", "1",
        "--save_path", str(tmp_path / "search_out")])
    blob = json.load(open(tmp_path / "search_out" / "iter_2.stats"))
    assert set(blob) == {"archive", "candidates", "hv", "surrogate",
                         "iteration"}
    assert len(blob["archive"]) + len(blob["candidates"]) == \
        len(out["archive"]) == out["n_evaluated"]
    assert 0 < blob["hv"] <= 1.0
