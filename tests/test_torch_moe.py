"""The port's sparse (Qwen2-MoE) layer held to its plain reference.

A tiny MoE (``tiny-qwen2-moe``: hidden 256, 4 q / 2 kv heads of 64, 8
experts of 128 keeping the top 2, a 256-wide shared expert, 2 layers,
vocab 512) packed at mixed widths from seeded random weights; the
reference (``models.moe_reference``) runs on the float32 weights the
packed model stands for.  Imports no JAX, so the card tests (marked
``cuda``, skipped without a card) run with::

    python -m pytest tests/test_torch_moe.py -m cuda --noconftest -q

Tolerances: float32 logits within 2e-4 absolute (the port's float32
tolerance; the sums differ in order only).  bf16 logits, as errors of a
position's logits over the largest reference logit: the median position
within 1e-2 and four in five within 2e-2 (bf16 rounds the residual
stream to 8 significant bits, about 0.4 % an operation), every position
within 0.25: where the router's k-th and (k+1)-th probabilities lie
closer than that rounding the float32 reference picks the other expert,
which moves that position by the two experts' difference times a top-k
weight, and later positions a little through attention (8 seeds of 64
positions: medians 0.5-0.8 %, up to 7 positions past 2e-2, the worst
0.15).
"""

import dataclasses

import numpy as np
import pytest
import torch

from amq_tpu_torch import ops
from amq_tpu_torch.models import linear as tlinear
from amq_tpu_torch.models import llama as tllama
from amq_tpu_torch.models import moe as tmoe
from amq_tpu_torch.models import moe_reference as ref
from amq_tpu_torch.models import stacked as tst
from amq_tpu_torch.models.config import (LINEAR_NAMES, MOE_LINEAR_NAMES,
                                         cycled_arch, get_config)
from amq_tpu_torch.models.transform import quantize_model
from amq_tpu_torch.ops import moe
from amq_tpu_torch.ops import quant_matmul as tqm
from amq_tpu_torch.serving import batched as tb
from amq_tpu_torch.serving.engine import ContinuousBatcher, Request

F32_TOL = 2e-4
BF16_MEDIAN, BF16_TOL, BF16_WITHIN, BF16_MAX = 1e-2, 2e-2, 0.8, 0.25


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(seed, bits=(2, 4), device="cpu"):
    cfg = get_config("tiny-qwen2-moe")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tmoe.init_moe_params(cfg, gen, device=device)
    model = tmoe.stack_moe(params, cfg, list(bits))
    return cfg, model, tmoe.dequantized_params(model, cfg)


@pytest.fixture(scope="module")
def tiny():
    return _build(0)


def _tokens(cfg, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n))


# ---------------------------------------------------------------------------
# configuration

def test_registry_has_qwen2_57b_a14b_at_published_widths():
    cfg = get_config("Qwen/Qwen2-57B-A14B")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim_, cfg.vocab_size) == (3584, 28, 28, 4, 128, 151936)
    assert (cfg.num_experts, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size,
            cfg.norm_topk_prob) == (64, 8, 2560, 20480, False)
    assert cfg.qkv_bias and cfg.rope_theta == 1e6 and cfg.rms_norm_eps == 1e-6
    assert cfg.linear_names == MOE_LINEAR_NAMES


def test_moe_topology_counts_every_expert():
    """avg bits count the experts' weights: a routed site is all 64
    experts; the router and the shared gate are not counted."""
    from amq_tpu_torch.evaluation.metrics import get_bits_usage
    cfg = get_config("Qwen2-57B-A14B")
    topo = cfg.topology()
    assert topo["linear"] == list(MOE_LINEAR_NAMES)
    H, E, I, S = 3584, 64, 2560, 20480
    attn = H * (28 * 128) * 2 + H * (4 * 128) * 2
    per_layer = attn + 3 * H * S + 3 * E * H * I
    assert cfg.model_numel() == 28 * per_layer
    arch = {"linear": {n: [4] * 28 for n in topo["linear"]}}
    assert get_bits_usage(arch, topo) == pytest.approx(4 + 32 / 128)
    # a dense config's topology is untouched
    dense = get_config("Qwen2.5-7B")
    assert dense.topology()["linear"] == list(LINEAR_NAMES)
    assert dense.model_numel() == 28 * dense.block_numel()
    assert cycled_arch(2)["linear"].keys() == set(LINEAR_NAMES)


# ---------------------------------------------------------------------------
# the model against the reference

def _port_logits(model, cfg, tok, dtype):
    m = tmoe.with_dtype(model, dtype) if dtype != torch.float32 else model
    lg, _ = tst.forward_stacked(m, cfg, tok[None], compute_dtype=dtype)
    return lg[0]


@pytest.mark.parametrize("seed,bits", [(0, (2, 4)), (1, (3, 4)), (2, (4, 2))])
def test_f32_logits_match_reference(seed, bits):
    cfg, model, dense = _build(seed, bits)
    tok = _tokens(cfg, 64, seed)
    got = _port_logits(model, cfg, tok, torch.float32)
    want = ref.forward(dense, cfg, tok)
    assert (got - want).abs().max() <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_logits_match_reference(seed):
    cfg, model, dense = _build(seed)
    tok = _tokens(cfg, 64, seed)
    _bf16_close(_port_logits(model, cfg, tok, torch.bfloat16),
                ref.forward(dense, cfg, tok))


def _bf16_close(got, want):
    """The bf16 tolerance (module docstring) on logits ``[S, V]``."""
    rows = ((got.float() - want.float()).abs().max(-1).values
            / want.float().abs().max()).cpu().numpy()
    assert np.median(rows) <= BF16_MEDIAN
    assert (rows <= BF16_TOL).mean() >= BF16_WITHIN, np.sort(rows)[-8:]
    assert rows.max() <= BF16_MAX


@pytest.mark.parametrize("variant", ["renormalised_topk", "no_shared_gate",
                                     "no_shared_expert"])
def test_variants_of_the_block_fail_the_f32_tolerance(tiny, variant):
    """A port that renormalised the top-k weights, dropped the shared
    expert's gate (sigmoid(0) = 1/2 in its place) or the shared expert is
    caught by the float32 comparison."""
    cfg, model, dense = tiny
    tok = _tokens(cfg, 64, 0)
    if variant == "renormalised_topk":
        cfg = dataclasses.replace(cfg, norm_topk_prob=True)
    elif variant == "no_shared_gate":
        model = dataclasses.replace(
            model, shared_gate=torch.zeros_like(model.shared_gate))
    else:
        model = dataclasses.replace(
            model, shared_gate=torch.full_like(model.shared_gate, -1e4))
    got = _port_logits(model, cfg, tok, torch.float32)
    assert (got - ref.forward(dense, get_config(cfg.name), tok)
            ).abs().max() > 100 * F32_TOL


def test_prefill_then_cached_decode_equals_full_forward(tiny):
    """Prefill 20 tokens into a cache, then 12 single-token steps through
    it: every position's float32 logits equal the reference's full
    forward."""
    cfg, model, dense = tiny
    tok = _tokens(cfg, 32, 5)
    want = ref.forward(dense, cfg, tok)
    cache = tllama.KVCache.create(cfg, 1, 64, dtype=torch.float32)
    got, cache = tst.forward_stacked(model, cfg, tok[None, :20], cache=cache,
                                     compute_dtype=torch.float32)
    rows = [got[0]]
    for t in range(20, 32):
        lg, cache = tst.forward_stacked(model, cfg, tok[None, t:t + 1],
                                        cache=cache,
                                        compute_dtype=torch.float32)
        rows.append(lg[0])
    assert (torch.cat(rows) - want).abs().max() <= F32_TOL


def _served_gap(dense, cfg, prompt, served):
    seq = torch.cat([torch.as_tensor(prompt).long(),
                     torch.as_tensor(served).long()])
    lg = ref.forward(dense, cfg, seq)
    rows = lg[len(prompt) - 1:len(seq) - 1]
    return float((rows.max(1).values
                  - rows.gather(1, seq[len(prompt):, None])[:, 0]).max())


@pytest.mark.parametrize("chunk_steps,chunk_len", [(1, None), (3, 8)])
def test_slot_engine_serves_the_reference_tokens(tiny, chunk_steps,
                                                 chunk_len):
    """Continuous batching through SlotEngine (two slots, staggered
    prompts, decode chunks, chunked prefill): every served token is the
    reference's best at its position, to the float32 tolerance."""
    cfg, model, dense = tiny
    rng = np.random.default_rng(3)
    prompts = {u: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for u, n in enumerate((5, 19, 11, 4))}
    eng = tb.SlotEngine(model, cfg, n_slots=2, max_len=64,
                        compute_dtype=torch.float32, device="cpu",
                        prefill_buckets=(8, 16, 24), chunk_steps=chunk_steps,
                        prefill_chunk_len=chunk_len)
    batcher = ContinuousBatcher(n_slots=2, max_len=64, use_native=False)
    for u, p in prompts.items():
        batcher.submit(Request(uid=u, prompt=p, max_new_tokens=6))
    out = eng.run(batcher)
    assert sorted(out) == sorted(prompts)
    for u, p in prompts.items():
        assert len(out[u]) == 6
        assert _served_gap(dense, cfg, p, out[u]) <= F32_TOL


def test_dense_config_never_reaches_the_moe_code(monkeypatch):
    """A dense stacked model's forward takes none of the MoE code and
    still equals the unrolled forward of the same quantized weights."""
    def refuse(*a, **k):
        raise AssertionError("the dense path reached the MoE code")

    for name in ("route", "moe_experts", "experts_plain", "moe_combine",
                 "combine_plain"):
        monkeypatch.setattr(moe, name, refuse)
    monkeypatch.setattr(tst, "_moe_mlp", refuse)
    cfg = get_config("tiny-qwen2")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(4))
    q = quantize_model(params, cfg, 4)
    model = tst.stack_proxies([q], (4,))
    tok = _tokens(cfg, 24, 4)[None]
    got, _ = tst.forward_stacked(model, cfg, tok, compute_dtype=torch.float32)
    want, _ = tllama.forward(q, cfg, tok, compute_dtype=torch.float32)
    assert (got - want).abs().max() <= F32_TOL


# ---------------------------------------------------------------------------
# the ops' plain versions

@pytest.mark.parametrize("bm", [16, 64])
def test_align_plain_lays_pairs_out_by_expert(bm):
    """Every pair once, grouped by expert in pair order, each expert's run
    padded with -1 to whole tiles, each tile naming its expert; experts
    with no pair (here 2, 5 and 7) get no tile."""
    rng = np.random.default_rng(bm)
    E, M, k = 8, 40, 2
    choices = np.array([0, 1, 3, 4, 6])
    ids = torch.from_numpy(np.stack([rng.choice(choices, k, replace=False)
                                     for _ in range(M)]))
    sorted_, tile_expert, hits = moe.align_plain(ids, E, bm)
    assert hits == len(choices)
    assert len(tile_expert) == moe.tiles_bound(M * k, E, bm)
    flat = ids.reshape(-1)
    seen = []
    for t, e in enumerate(tile_expert.tolist()):
        block = sorted_[t * bm:(t + 1) * bm].tolist()
        if e < 0:
            assert set(block) == {-1}
            continue
        real = [p for p in block if p >= 0]
        assert all(int(flat[p]) == e for p in real)
        seen += real
    assert sorted(seen) == list(range(M * k))
    for e in range(E):
        mine = [p for p in seen if int(flat[p]) == e]
        assert mine == sorted(mine) == [p for p in range(M * k)
                                        if int(flat[p]) == e]
        n_tiles = int((tile_expert == e).sum())
        assert n_tiles == -(-len(mine) // bm)
    assert not set((tile_expert[tile_expert >= 0]).tolist()) & {2, 5, 7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_experts_plain_equals_a_per_pair_loop(tiny, dtype):
    """Each pair's output is its own expert's gate|up -> SwiGLU -> down
    through the dense MLP's plain products, pair by pair, with two experts
    left without a pair."""
    cfg, model, _ = tiny
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6, cfg.hidden_size))
                         .astype(np.float32)).to(dtype)
    ids = torch.from_numpy(np.stack([rng.choice(6, k, replace=False)
                                     for _ in range(6)]))
    b, slot = model.select["mlp.experts.gateup_proj"][1], model.slots[1]
    gu = model.experts["mlp.experts.gateup_proj"][b]
    dn = model.experts["mlp.experts.down_proj"][b]
    kw = dict(num_experts=E, nbits=gu.nbits, group_size=128,
              gu_superblock=gu.superblock, dn_superblock=dn.superblock,
              out_dtype=dtype)
    y = moe.experts_plain(x, ids, gu.packed, gu.scale, gu.zero, dn.packed,
                          dn.scale, dn.zero, slot * E, **kw)
    plain = tqm.qmm_tile_plain if dtype == torch.bfloat16 else tqm.qmm_plain
    I = cfg.moe_intermediate_size
    for p in range(6 * k):
        w = slot * E + int(ids.reshape(-1)[p])
        row = x[p // k:p // k + 1]
        g = plain(row, gu.packed[w], gu.scale[w], gu.zero[w], nbits=gu.nbits,
                  group_size=128, shape=(2 * I, cfg.hidden_size),
                  superblock=gu.superblock, out_dtype=dtype)
        want = plain(g[:, :I], dn.packed[w], dn.scale[w], dn.zero[w],
                     nbits=dn.nbits, group_size=128,
                     shape=(cfg.hidden_size, I), superblock=dn.superblock,
                     out_dtype=dtype, up=g[:, I:])
        # one row alone against the expert's batch: the library's f32
        # sums may part in the last bits, and then a bf16 rounding
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert ((y[p:p + 1].float() - want.float()).abs().max()
                <= tol * want.float().abs().max())


def test_combine_plain_weights_pairs_and_gates_the_shared_expert():
    rng = np.random.default_rng(9)
    M, k, H = 3, 2, 16
    y = torch.from_numpy(rng.normal(size=(M * k, H)).astype(np.float32))
    w = torch.from_numpy(rng.random((M, k)).astype(np.float32))
    sh = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=M).astype(np.float32))
    got = moe.combine_plain(y, w, sh, s)
    for m in range(M):
        want = (w[m, 0] * y[m * k] + w[m, 1] * y[m * k + 1]
                + torch.sigmoid(s[m]) * sh[m])
        assert torch.allclose(got[m], want, atol=1e-6)


def test_route_keeps_unnormalised_softmax_top_k():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    w, ids = moe.route(x, router, 3)
    p = torch.softmax(x @ router.T, -1)
    assert torch.equal(ids, torch.argsort(p, -1, descending=True)[:, :3])
    assert torch.allclose(w, p.gather(1, ids))
    assert (w.sum(-1) < 1).all()
    wn, _ = moe.route(x, router, 3, norm_topk_prob=True)
    assert torch.allclose(wn.sum(-1), torch.ones(5))


def test_replayed_routing_reproduces_the_forward(tiny, monkeypatch):
    """The card test's routing replay (``_route_as``) fed the forward's
    own experts gives the same logits bit for bit."""
    cfg, model, _ = tiny
    tok = _tokens(cfg, 12, 5)[None]
    route, recorded = moe.route, []

    def recording(*args, **kw):
        out = route(*args, **kw)
        recorded.append(out[1])
        return out

    monkeypatch.setattr(moe, "route", recording)
    want, _ = tst.forward_stacked(model, cfg, tok,
                                  compute_dtype=torch.float32)
    monkeypatch.setattr(moe, "route", _route_as(recorded))
    got, _ = tst.forward_stacked(model, cfg, tok,
                                 compute_dtype=torch.float32)
    assert not recorded
    assert torch.equal(got, want)


def test_moe_spans_and_pair_counter_record_under_the_profiler(tiny):
    from torch.profiler import profile
    from amq_tpu_torch.utils import profiling, span_readings
    cfg, model, _ = tiny
    profiling.TRACER.reset()
    with profile():
        tst.forward_stacked(model, cfg, _tokens(cfg, 10, 1)[None],
                            compute_dtype=torch.float32)
    names = {s.name for s in profiling.TRACER.spans}
    assert {"moe.route", "moe.experts", "moe.shared"} <= names
    assert profiling.TRACER.counters["moe.pairs"] == 2 * 10 * 2
    before = torch.zeros((2, len(moe.COUNTS), moe.MAX_LAYERS),
                         dtype=torch.int64)
    after = before.clone()
    after[0, 0, :2] = torch.tensor([5, 6])     # experts hit, two layers
    after[0, 2, :2] = 8                         # experts offered
    moe.fold_counters(profiling.TRACER, before, after)
    assert span_readings.experts_hit_share() == pytest.approx(100 * 11 / 16)
    assert moe.counter_rise(before, after)["gemv"]["experts_hit"] == 11
    profiling.TRACER.reset()


@pytest.mark.parametrize("bm", [16, 64])
def test_smoke_align_check_ignores_order_inside_an_expert(bm):
    """chip_smoke's check of ``moe_align``: the plain layout with each
    expert's pairs reversed passes, one pair moved to another expert's
    tile fails."""
    import chip_smoke
    ids = torch.from_numpy(np.random.default_rng(bm).integers(
        0, chip_smoke.MOE_E, (40, chip_smoke.MOE_K)))
    tiles = moe.tiles_bound(ids.numel(), chip_smoke.MOE_E, bm)
    s, t, _ = moe.align_plain(ids, chip_smoke.MOE_E, bm, tiles)
    assert chip_smoke.align_layout_equal((s, t), (s, t), bm, tiles)
    flipped = s.clone().reshape(tiles, bm)
    for e in t.unique():
        rows = flipped[t == e].reshape(-1)
        flipped[t == e] = rows.flip(0).reshape(-1, bm)
    assert not torch.equal(flipped.reshape(-1), s)
    assert chip_smoke.align_layout_equal((flipped.reshape(-1), t), (s, t),
                                         bm, tiles)
    moved = s.clone()
    a, b = 0, int((t == t[t >= 0].max()).nonzero()[0, 0]) * bm
    moved[a], moved[b] = s[b], s[a]
    assert not chip_smoke.align_layout_equal((moved, t), (s, t), bm, tiles)


def test_smoke_reckons_the_moe_calls_of_a_forward(tiny, monkeypatch):
    """chip_smoke's reckoning of the MoE kernels' launches per forward
    (per layer one align, two expert products, one combine) against the
    calls a prefill and a decode step of the tiny MoE make."""
    import chip_smoke
    cfg, model, _ = tiny
    calls = {"align": 0, "experts": 0, "combine": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(moe, "experts_plain",
                        counted("experts", moe.experts_plain))
    monkeypatch.setattr(moe, "combine_plain",
                        counted("combine", moe.combine_plain))
    tok = _tokens(cfg, 20, 2)[None]
    tst.forward_stacked(model, cfg, tok, compute_dtype=torch.float32)
    tst.forward_stacked(model, cfg, tok[:, :1], compute_dtype=torch.float32)
    launches, forms = chip_smoke.reckon_moe(cfg.num_layers, 1, 1)
    # one experts call is an align and two products on the card
    assert launches == {"moe_align": calls["experts"],
                        "moe_experts": 2 * calls["experts"],
                        "moe_combine": calls["combine"]}
    assert forms == {"gemv": 2 * cfg.num_layers, "tile": 2 * cfg.num_layers}


# ---------------------------------------------------------------------------
# the kernels on a card, at the cell's shapes

CELL = dict(H=3584, I=2560, E=64, k=8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _random_stack(E, K, N, nbits, gen, dev):
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    sb, pad = pick_superblock_padded(K, 128)
    assert pad == 0
    words = torch.randint(-2**31, 2**31 - 1, (E, K * nbits // 32, N),
                          dtype=torch.int32, device=dev, generator=gen)
    std = ((4**nbits - 1) / 12) ** 0.5
    scale = ((torch.rand((E, K // 128, N), generator=gen, device=dev) + 0.5)
             / (K ** 0.5 * std)).to(torch.bfloat16)
    zero = (torch.rand((E, K // 128, N), generator=gen, device=dev) - 0.5
            + (2**nbits - 1) / 2).to(torch.bfloat16)
    return words, scale, zero, sb


def _ids(M, E, k, gen, dev):
    return torch.argsort(torch.rand((M, E), generator=gen, device=dev),
                         dim=1)[:, :k].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 1024])
def test_cuda_moe_align_matches_plain(M):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(M)
    E, k = CELL["E"], CELL["k"]
    ids = _ids(M, E, k, gen, dev)
    bm = moe.TILE_ROWS[moe.form(M)]
    tiles = moe.tiles_bound(M * k, E, bm)
    c = moe.device_counters(dev)
    before = c.clone()
    s, t = moe.moe_align(ids, E, bm, tiles, layer=3,
                         form_index=int(moe.form(M) == "tile"))
    ps, pt, hits = moe.align_plain(ids, E, bm, tiles)
    torch.cuda.synchronize()
    assert torch.equal(t.cpu(), pt.cpu())
    # inside an expert's tiles the kernel's order is its atomics'
    per_tile = [s.cpu().reshape(tiles, bm), ps.cpu().reshape(tiles, bm)]
    for e in range(-1, E):
        mine = [x[pt.cpu() == e].reshape(-1).sort().values for x in per_tile]
        assert torch.equal(*mine)
    rise = moe.counter_rise(before.cpu(), c.cpu())[moe.form(M)]
    assert (rise["experts_hit"], rise["pairs"], rise["experts"]) == (
        hits, M * k, E)
    assert rise["experts_hit_by_layer"][3] == hits


def _norm_close(got, want, atol):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= atol, err


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4])
@pytest.mark.parametrize("M", [1, 8, 64, 1024])
def test_cuda_moe_experts_match_plain(nbits, M):
    """The expert products at the cell's widths (64 experts, top 8, hidden
    3584, width 2560) against their plain version on the same card, bf16
    out normalized by its largest magnitude within 2e-2 (the two sum the
    same bf16 products in another order, and a bf16 rounding of gate or up
    can part before the down product); the stack's layer is not its first
    (``first`` = 64)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(100 + M + nbits)
    H, I, E, k = CELL["H"], CELL["I"], CELL["E"], CELL["k"]
    gu = _random_stack(2 * E, H, 2 * I, nbits, gen, dev)
    dn = _random_stack(2 * E, I, H, nbits, gen, dev)
    x = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    ids = _ids(M, E, k, gen, dev)
    kw = dict(num_experts=E, nbits=nbits, group_size=128,
              gu_superblock=gu[3], dn_superblock=dn[3],
              out_dtype=torch.bfloat16)
    before = moe.moe_experts.launches
    got = moe.moe_experts(x, ids, *gu[:3], *dn[:3], E, layer=0, **kw)
    want = moe.experts_plain(x, ids, *gu[:3], *dn[:3], E, **kw)
    torch.cuda.synchronize()
    assert moe.moe_experts.launches == before + 2
    _norm_close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 1024])
def test_cuda_moe_combine_matches_plain(M):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(M)
    H, k = CELL["H"], CELL["k"]
    y = torch.randn((M * k, H), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.rand((M, k), generator=gen, device=dev)
    sh = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    s = torch.randn((M,), generator=gen, device=dev)
    got = moe.moe_combine(y, w, sh, s, out_dtype=torch.bfloat16)
    want = moe.combine_plain(y, w, sh, s, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _norm_close(got, want, 1e-2)


def _route_as(recorded):
    """``moe.route`` taking each call's experts from ``recorded`` (one
    ``[M, k]`` tensor per call, in call order) and their probabilities
    from this call's own float32 router logits."""
    def route(x, router, k, norm_topk_prob=False):
        ids = recorded.pop(0)
        probs = torch.softmax(torch.matmul(x.float(), router.float().T), -1)
        w = probs.gather(1, ids)
        if norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        return w, ids
    return route


@pytest.mark.cuda
def test_cuda_tiny_moe_serves_through_graphs_as_the_plain_path(monkeypatch):
    """The tiny MoE on the card: the kernels' logits against the plain
    path's (``use_kernels`` off) on the same experts -- the plain path's
    routing recorded and replayed into the kernel path, so a k-th /
    (k+1)-th choice that a bf16 rounding flips cannot part them -- within
    2e-2 of the largest logit, and SlotEngine on captured graphs serving
    the same tokens as without graphs."""
    dev = _card()
    cfg, model, _ = _build(0)
    model = tmoe.with_dtype(_to(model, dev), torch.bfloat16)
    tok = _tokens(cfg, 48, 0).to(dev)[None]
    route, recorded = moe.route, []

    def recording(*args, **kw):
        out = route(*args, **kw)
        recorded.append(out[1])
        return out

    monkeypatch.setattr(moe, "route", recording)
    want, _ = tst.forward_stacked(model, cfg, tok,
                                  compute_dtype=torch.bfloat16)
    assert len(recorded) == cfg.num_layers
    monkeypatch.setattr(moe, "route", _route_as(recorded))
    from amq_tpu_torch.serving.engine import kernel_linear_impl
    with tlinear.kernel_linears(kernel_linear_impl), \
            tllama.forward_kernels(True):
        got, _ = tst.forward_stacked(model, cfg, tok,
                                     compute_dtype=torch.bfloat16)
    assert not recorded
    monkeypatch.setattr(moe, "route", route)
    _norm_close(got[0], want[0], 2e-2)
    outs = []
    for graphs in (True, False):
        eng = tb.SlotEngine(model, cfg, n_slots=4, max_len=128,
                            compute_dtype=torch.bfloat16, device=dev,
                            prefill_buckets=(16, 32), chunk_steps=4,
                            graphs=graphs)
        batcher = ContinuousBatcher(n_slots=4, max_len=128)
        rng = np.random.default_rng(1)
        for u in range(6):
            batcher.submit(Request(uid=u, prompt=rng.integers(
                0, cfg.vocab_size, 5 + 4 * u).astype(np.int32),
                max_new_tokens=9))
        outs.append(eng.run(batcher))
    assert outs[0] == outs[1]


def _to(model, dev):
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, tst.StackedQuant):
            return dataclasses.replace(v, packed=v.packed.to(dev),
                                       scale=v.scale.to(dev),
                                       zero=v.zero.to(dev))
        if isinstance(v, tuple):
            return tuple(move(u) for u in v)
        if isinstance(v, dict):
            return {n: move(u) for n, u in v.items()}
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: move(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        return v
    return move(model)
