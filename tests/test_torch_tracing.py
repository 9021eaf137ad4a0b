"""The port's tracer (``amq_tpu_torch.utils.profiling.TRACER``) and the
spans and counters the serving loop, the graph runner and the evaluator
record into it, on the CPU.

With no profiler running a span reads one flag and nothing else: the
clock and ``record_function`` are replaced by functions that raise, and
a whole serving run and an evaluation still go through.  Under a CPU
``torch.profiler.profile`` spans keep their parent and request id and
appear in the profiler's events as ``amq.<name>`` annotations; the
counters match what the inputs reckon.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from amq_tpu_torch import ops
from amq_tpu_torch.evaluation import Evaluator
from amq_tpu_torch.models import llama
from amq_tpu_torch.models.config import LINEAR_NAMES, cycled_arch, get_config
from amq_tpu_torch.models.stacked import stack_proxies
from amq_tpu_torch.models.transform import quantize_model
from amq_tpu_torch.serving import batched as tb
from amq_tpu_torch.serving.engine import ContinuousBatcher, Request
from amq_tpu_torch.utils import profiling

from test_torch_graphs import _CpuCard, _launching_body
from test_torch_slice import torch_one_thread  # noqa: F401

BITS = (2, 3, 4)
TRACER = profiling.TRACER


@pytest.fixture
def tracer():
    TRACER.reset()
    yield TRACER
    TRACER.reset()


def _raise(*a, **k):
    raise AssertionError("called with no profiler running")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-llama")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0))
    proxies = [quantize_model(params, cfg, b, meta_dtype=torch.bfloat16,
                              optimize=False) for b in BITS]
    served = stack_proxies(proxies, BITS, cycled_arch(cfg.num_layers, BITS),
                           fuse="never", lane_pad=False)
    return cfg, params, proxies, served


# ---------------------------------------------------------------------------
# the tracer itself

def test_span_without_profiler_reads_only_the_flag(tracer, monkeypatch):
    """Off: every span is one shared no-op context, and neither the clock
    nor ``record_function`` is called; counts and queued spans add
    nothing."""
    monkeypatch.setattr(profiling, "record_function", _raise)
    monkeypatch.setattr(profiling, "_now", _raise)
    monkeypatch.setattr(profiling, "_launch_state", _raise)
    assert not tracer.on
    a, b = tracer.span("serve.step"), tracer.span("eval.arch", 3, True)
    assert a is b
    with a:
        with b:
            tracer.count("serve.prefill_rows", 64)
    tracer.begin("serve.queued", 1)
    tracer.end("serve.queued", 1)
    assert tracer.spans == [] and tracer.counters == {}
    assert tracer.summary() == {}


def test_spans_under_profiler_nest_and_land_in_its_events(tracer):
    """On: spans keep start, end, parent and request id; each is an
    ``amq.<name>`` annotation in the profile, nested as the spans are; a
    queued span opened and closed in different calls has no parent; once
    the profile stops nothing more is recorded."""
    with _cpu_profile() as prof:
        assert tracer.on
        tracer.begin("serve.queued", 7)
        with tracer.span("serve.step") as step:
            tracer.end("serve.queued", 7)
            with tracer.span("serve.prefill", 7):
                with tracer.span("serve.readback"):
                    tracer.count("serve.prefill_rows", 64)
                    tracer.count("serve.prefill_rows", 32)
        tracer.end("serve.queued", 8)           # never begun: nothing
    with tracer.span("serve.step"):
        tracer.count("serve.prefill_rows", 1)
    assert step.name == "serve.step"
    got = [(s.name, s.parent, s.uid) for s in tracer.spans]
    assert got == [("serve.step", None, None), ("serve.queued", None, 7),
                   ("serve.prefill", 0, 7), ("serve.readback", 2, None)]
    assert all(s.end_ns >= s.start_ns > 0 for s in tracer.spans)
    q, p = tracer.spans[1], tracer.spans[2]
    assert q.end_ns <= p.start_ns
    assert dict(tracer.counters) == {"serve.prefill_rows": 96}
    assert tracer.summary()["serve.step"]["count"] == 1
    ann = {e.name: e.time_range for e in prof.events()
           if e.name.startswith("amq.")}
    assert set(ann) == {"amq.serve.step", "amq.serve.prefill",
                        "amq.serve.readback"}
    outer, mid, inner = (ann[f"amq.serve.{n}"]
                         for n in ("step", "prefill", "readback"))
    assert outer.start <= mid.start <= inner.start
    assert inner.end <= mid.end <= outer.end


def test_runner_spans_and_the_launch_counters_rise(tracer):
    """A span asked for launches holds the counters' rise over it (graph
    replays included, as ``ops`` counts them); every replay is a
    ``serve.launch`` span, and the capture is counted by the runner."""
    ops.reset_launch_counts()
    runner = _CpuCard()
    state = [torch.zeros(1, dtype=torch.int64), torch.ones(2)]
    runner.watch = state
    body = _launching_body(state)
    with _cpu_profile():
        with tracer.span("outer", launches=True) as rec:
            runner.run(("step", 1), body, state=state, times=5)
            runner.run(("step", 1), body, state=state, times=2)
    assert rec.launches == {"quant_matmul_indexed.launches": 14,
                            "quant_matmul_indexed.grouped_launches": 14,
                            "decode_attention_indexed.launches": 7}
    names = [s.name for s in tracer.spans]
    assert names == ["outer"] + ["serve.launch"] * 7
    assert runner.captures == 1
    ops.reset_launch_counts()


@pytest.mark.parametrize("keep", [False, True], ids=["totals", "spans"])
def test_plain_tracer_keeps_spans_only_when_asked(keep):
    """A plain ``Tracer`` records with no profiler running; it keeps the
    totals by name, and each span (with parent and request id) only with
    ``keep_spans``."""
    t = profiling.Tracer(keep_spans=keep)
    with t.span("a"):
        with t.span("b", 3) as rec:
            pass
    with t.span("a"):
        t.count("n", 2)
    assert rec.name == "b" and rec.uid == 3 and rec.end_ns >= rec.start_ns
    assert {k: v["count"] for k, v in t.summary().items()} == {"a": 2, "b": 1}
    assert dict(t.counters) == {"n": 2}
    got = [(s.name, s.parent, s.uid) for s in t.spans]
    assert got == ([("a", None, None), ("b", 0, 3), ("a", None, None)]
                   if keep else [])


def test_queued_span_of_an_ended_session_is_dropped(tracer):
    """A request queued under one profile and admitted while none runs
    leaves nothing behind for the next profile; one still queued when the
    next profile admits it keeps its submission time."""
    with _cpu_profile():
        tracer.begin("serve.queued", 1)
        tracer.begin("serve.queued", 2)
    tracer.end("serve.queued", 1)
    with _cpu_profile():
        tracer.end("serve.queued", 1)
        tracer.end("serve.queued", 2)
    assert [(s.name, s.uid) for s in tracer.spans] == [("serve.queued", 2)]
    assert tracer._waiting == {}


def test_probe_labels_idle_gaps_by_innermost_port_span():
    """``probes.serve_spans.idle_by_span``: the slice's device idle by the
    latest-begun ``amq.*`` span at each gap's middle, gaps under 50 µs
    between kernels, nothing without a slice."""
    from amq_tpu_torch.probes import serve_spans
    ms = 1_000_000
    events = [("span", 0, 100 * ms, "perfbench.slice"),
              ("span", 0, 100 * ms, "perfbench.iteration"),
              ("device", 0, 10 * ms, "k0"),
              ("span", 5 * ms, 95 * ms, "amq.serve.decode"),
              ("span", 12 * ms, 45 * ms, "amq.serve.launch"),
              ("cpu", 12 * ms, 13 * ms, "cudaGraphLaunch"),
              ("device", 40 * ms, 50 * ms, "k1"),
              ("device", 50 * ms + 20_000, 90 * ms, "k2")]
    got = serve_spans.idle_by_span(events)
    assert got == pytest.approx({"serve.launch": 0.030,
                                 "between kernels": 20e-6,
                                 "serve.decode": 0.010})
    assert serve_spans.idle_by_span(events[1:]) == {}
    assert serve_spans._us([1000, 3000]) == dict(n=2, mean=2.0, p50=2.0,
                                                 p95=pytest.approx(2.9))
    assert serve_spans._us([]) == dict(n=0)


# ---------------------------------------------------------------------------
# the readings of a tracer filled by hand

MS = 1_000_000


def _filled():
    Span = profiling.Span
    t = profiling.Tracer(keep_spans=True)
    t.counters.update({"serve.prefill_rows": 1724, "serve.prefill_tokens": 1201,
                       "serve.decode_slot_steps": 640,
                       "serve.decode_tokens": 627, "eval.linears": 392})
    t.spans += [
        # request 1: queued 0-10 ms, prefill from 10, first token at 40 ms
        Span("serve.queued", 0, 10 * MS, uid=1),
        Span("serve.prefill", 10 * MS, 38 * MS, uid=1),
        Span("serve.launch", 12 * MS, 13 * MS, parent=1),
        Span("serve.readback", 14 * MS, 30 * MS, parent=1),
        Span("serve.bookkeeping", 38 * MS, 40 * MS, uid=1),
        # the decode chunk: launched 30 + 5 ms after the read, read again
        Span("serve.launch", 34 * MS, 35 * MS),
        Span("serve.readback", 36 * MS, 50 * MS),
        Span("serve.bookkeeping", 50 * MS, 51 * MS),
        # request 2: submitted before the slice, so its queued span is not
        # there; request 3: queued, its first token after the slice
        Span("serve.bookkeeping", 52 * MS, 53 * MS, uid=2),
        Span("serve.queued", 20 * MS, 60 * MS, uid=3),
        # the device is dry from the first readback after a launch on
        Span("serve.readback", 61 * MS, 62 * MS),
        Span("serve.readback", 63 * MS, 64 * MS),
        Span("serve.launch", 66 * MS, 70 * MS),
        Span("eval.arch", 100 * MS, 200 * MS,
             launches={"dequantize_kn.launches": 1568, "flash.launches": 28}),
        Span("eval.arch", 200 * MS, 300 * MS,
             launches={"dequantize_kn.launches": 1568}),
    ]
    return t


WANT = {
    "prefill_pad_share.serve": 100.0 * 523 / 1724,
    "decode_yield.serve": 100.0 * 627 / 640,
    # (35 - 30) + (70 - 50) ms over a 100 ms slice
    "host_gap_share.serve": 25.0,
    # request 1 alone: 10 ms queued of 40
    "ttft_queued_share.serve": 25.0,
    "dequant_yield.eval": 12.5,
}
SLICE_S = 0.1


@pytest.mark.parametrize("name", sorted(WANT))
def test_reading_of_a_filled_tracer_or_nothing(name, monkeypatch):
    """Each reading of ``utils.span_readings`` reads its number from a
    tracer filled by hand, nothing from an empty one, and the program's
    ``TRACER`` when given none."""
    from amq_tpu_torch.utils import span_readings as sr
    fn = getattr(sr, name.split(".")[0])
    call = ((lambda t: fn(SLICE_S, t)) if name.startswith("host_gap")
            else fn)
    assert call(_filled()) == pytest.approx(WANT[name])
    assert call(profiling.Tracer(keep_spans=True)) is None
    monkeypatch.setattr(profiling, "TRACER", _filled())
    assert call(None) == pytest.approx(WANT[name])


def test_readings_name_each_reading_and_need_a_slice_for_the_gap():
    from amq_tpu_torch.utils import span_readings as sr
    assert sr.readings(SLICE_S, _filled()) == pytest.approx(WANT)
    assert sr.readings(SLICE_S, profiling.Tracer(keep_spans=True)) == {}
    assert sr.host_gap_share(None, _filled()) is None
    assert "host_gap_share.serve" not in sr.readings(None, _filled())


def test_host_gap_split_by_innermost_span():
    """``span_readings.gaps`` and ``split``: each gap's time by the
    latest-begun span over it (queued spans left out), ``no span`` where
    none is, summing to the gaps."""
    from amq_tpu_torch.utils import span_readings as sr
    spans = _filled().spans
    held = sr.gaps(spans)
    assert held == [(30 * MS, 35 * MS), (50 * MS, 70 * MS)]
    got = sr.split(spans, held)
    assert got == pytest.approx({"serve.prefill": 0.004, "serve.launch": 0.005,
                                 "serve.bookkeeping": 0.002,
                                 "serve.readback": 0.002, "no span": 0.012})
    assert sr.split(spans, []) == {}


# ---------------------------------------------------------------------------
# the serving loop

#: (prompt length, new tokens): one retires at its prefill, one spans the
#: largest bucket's chunked prefill
REQUESTS = [(5, 6), (17, 4), (30, 1), (9, 9), (3, 5), (26, 7)]
BUCKETS = (8, 16, 32)


def _serve(served, cfg, chunk_steps, prefill_chunk_len, monkeypatch):
    """A 2-slot engine over REQUESTS; returns (results, decode steps
    run)."""
    steps = {"n": 0}
    body = tb.slot_decode_step

    def counted(*a, **k):
        steps["n"] += 1
        return body(*a, **k)
    monkeypatch.setattr(tb, "slot_decode_step", counted)
    eng = tb.SlotEngine(served, cfg, n_slots=2, max_len=64,
                        compute_dtype=torch.float32, prefill_buckets=BUCKETS,
                        chunk_steps=chunk_steps,
                        prefill_chunk_len=prefill_chunk_len, device="cpu")
    batcher = ContinuousBatcher(n_slots=2, max_len=64, use_native=False)
    rng = np.random.default_rng(0)
    for uid, (p, o) in enumerate(REQUESTS):
        batcher.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, p).astype(np.int32), max_new_tokens=o))
    out = eng.run(batcher)
    return out, steps["n"]


@pytest.mark.parametrize("chunk_steps,prefill_chunk_len",
                         [(4, None), (1, None), (3, 12)],
                         ids=["decode_chunks", "single_steps",
                              "chunked_prefill"])
def test_slot_engine_counts_rows_steps_and_requests(
        tiny, tracer, monkeypatch, chunk_steps, prefill_chunk_len):
    """Under a profiler: ``serve.prefill_rows`` is the buckets' (or the
    chunks') rows, ``serve.prefill_tokens`` the prompts' tokens,
    ``serve.decode_slot_steps`` slots x steps run, ``serve.decode_tokens``
    the tokens decoded into requests; one ``serve.queued``, one
    ``serve.prefill`` and one first-token ``serve.bookkeeping`` per
    request, by uid.  The tokens are those of a run with no profiler, in
    which the tracer records nothing."""
    cfg, _, _, served = tiny
    with monkeypatch.context() as m:
        m.setattr(profiling, "record_function", _raise)
        m.setattr(profiling, "_now", _raise)
        plain, _ = _serve(served, cfg, chunk_steps, prefill_chunk_len, m)
    assert tracer.spans == [] and tracer.counters == {}
    with _cpu_profile() as prof:
        got, steps = _serve(served, cfg, chunk_steps, prefill_chunk_len,
                            monkeypatch)
    assert got == plain
    assert sorted(got) == list(range(len(REQUESTS)))
    C = prefill_chunk_len
    rows = sum(min(b for b in BUCKETS if p <= b) if C is None or p <= C
               else -(-p // C) * C for p, _ in REQUESTS)
    c = tracer.counters
    assert c["serve.prefill_rows"] == rows
    assert c["serve.prefill_tokens"] == sum(p for p, _ in REQUESTS)
    assert c["serve.decode_slot_steps"] == 2 * steps
    assert c["serve.decode_tokens"] == sum(o - 1 for _, o in REQUESTS)
    uids = list(range(len(REQUESTS)))
    by = {}
    for s in tracer.spans:
        by.setdefault(s.name, []).append(s)
    assert sorted(s.uid for s in by["serve.queued"]) == uids
    assert sorted(s.uid for s in by["serve.prefill"]) == uids
    first = [s.uid for s in by["serve.bookkeeping"] if s.uid is not None]
    assert sorted(first) == uids
    for q in by["serve.queued"]:
        p = next(s for s in by["serve.prefill"] if s.uid == q.uid)
        assert q.start_ns <= q.end_ns <= p.start_ns
    spans = tracer.spans
    for name in ("serve.preempt", "serve.fill", "serve.prefill",
                 "serve.decode"):
        assert all(spans[s.parent].name == "serve.step" for s in by[name])
    for s in by["serve.readback"] + by["serve.launch"]:
        assert spans[s.parent].name in ("serve.prefill", "serve.decode",
                                        "serve.step")
    assert len(by["serve.decode"]) * chunk_steps == steps
    # one launch a decode step and a prefill (or prefill chunk)
    prefills = sum(1 if C is None or p <= C else -(-p // C)
                   for p, _ in REQUESTS)
    assert len(by["serve.launch"]) == steps + prefills
    events = {e.name for e in prof.events()}
    assert {"amq.serve.step", "amq.serve.launch",
            "amq.serve.readback"} <= events


# ---------------------------------------------------------------------------
# the evaluator

def test_eval_many_records_one_arch_span_per_architecture(tiny, tracer):
    """Under a profiler ``eval_many`` records one ``eval.arch`` per
    architecture (its ``set_arch``, one ``forward`` and one ``jsd`` per
    loss batch inside it, and the launch counters' rise), ``eval.linears``
    of layers x sites per architecture and one ``eval.readback``; the
    losses are those of an untraced call."""
    cfg, params, proxies, _ = tiny
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 32)).astype(np.int32)
    ev = Evaluator(cfg, dense_params=params, proxies=proxies,
                   bits_range=BITS, datasets={"s": toks}, batch_size=2,
                   compute_dtype=torch.float32, device="cpu")
    archs = [cycled_arch(cfg.num_layers, BITS),
             {"linear": {n: [4] * cfg.num_layers for n in LINEAR_NAMES}}]
    plain = ev.eval_many(archs)
    assert tracer.spans == []
    with _cpu_profile():
        got = ev.eval_many(archs)
    assert got == plain
    spans = tracer.spans
    arch = [i for i, s in enumerate(spans) if s.name == "eval.arch"]
    assert len(arch) == len(archs)
    assert all(spans[i].launches is not None for i in arch)
    assert tracer.counters["eval.linears"] == (
        len(archs) * cfg.num_layers * len(LINEAR_NAMES))
    for name, per_arch in (("eval.set_arch", 1), ("eval.forward", 2),
                           ("eval.jsd", 2)):
        parents = [s.parent for s in spans if s.name == name]
        assert sorted(parents) == sorted(arch * per_arch), name
    assert [s.parent for s in spans if s.name == "eval.readback"] == [None]
