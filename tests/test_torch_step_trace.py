"""The port's step spans (``repro_torch.engine.steptrace``) on the CPU: one
span tree a step that did work, each child inside its parent, the passes
against the executor's own counts, the same greedy tokens with the tracer
on and off, the spans on ``torch.profiler``'s clock, no clock read with no
tracer attached, and the bounded ring."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.config import GPU_H100  # noqa: E402
from repro_torch.engine import steptrace  # noqa: E402
from repro_torch.engine.engine import LLMEngine  # noqa: E402
from repro_torch.engine.executor import SimExecutor  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.launch import drive  # noqa: E402
from repro_torch.models import api  # noqa: E402

PROMPTS = (9, 40, 100, 23)
NEW = 5
# a profiler event is inside a span up to this much, in ns: the anchor's
# two clocks are read back to back, and kineto stamps CPU ops in the same
# Unix-epoch ns
CLOCK_TOLERANCE_NS = 50_000


@pytest.fixture(scope="module")
def models():
    """A reduced dense model and a reduced slot-state one, on the CPU."""
    out = {}
    for name in ("mistral-small-24b", "recurrentgemma-9b"):
        cfg = configs.get(name).reduced()
        out[name] = cfg, api.init_params(
            cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    return out


def _engine(cfg, params, max_prefill_tokens=64):
    return drive.build_engine(cfg, params, "cpu", num_blocks=64,
                              block_size=16, max_num_seqs=4,
                              max_prefill_tokens=max_prefill_tokens,
                              max_model_len=256)


def _requests(vocab, lengths=PROMPTS):
    prompts = drive.make_prompts(vocab, lengths, seed=5)
    return [Request(prompt_tokens=p, sampling=SamplingParams(
        temperature=0.0, max_new_tokens=NEW)) for p in prompts]


def _serve(engine, reqs):
    """Serve to the end; the number of steps that scheduled work."""
    for r in reqs:
        engine.add_request(r, 0.0)
    worked = 0
    while engine.has_work():
        worked += engine.step(0.0).kind != "idle"
    return worked


def _traced(cfg, params, **kw):
    engine = _engine(cfg, params, **kw)
    tracer = steptrace.attach(engine, steptrace.StepTracer())
    reqs = _requests(cfg.vocab_size)
    return engine, tracer, reqs, _serve(engine, reqs)


@pytest.mark.parametrize("name", ["mistral-small-24b", "recurrentgemma-9b"])
def test_one_tree_a_step_each_child_inside_its_parent(models, name):
    cfg, params = models[name]
    _, tracer, _, worked = _traced(cfg, params)
    spans = list(tracer.spans)
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.parent_id is None]
    assert worked > 0 and len(roots) == worked
    assert {s.name for s in roots} == {"engine.step"}
    assert {s.name for s in spans} == set(steptrace.STEP_SPANS)
    for s in spans:
        assert s.end is not None and s.start <= s.end and s.status == "ok"
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.start <= s.start and s.end <= p.end
    parents = {"engine.schedule": "engine.step", "executor.step":
               "engine.step", "engine.sample": "engine.step",
               "executor.prepare": "executor.step",
               "executor.launch": "executor.step",
               "executor.to_host": "executor.step"}
    for s in spans:
        if s.parent_id is not None:
            assert by_id[s.parent_id].name == parents[s.name]
    # each step: schedule, then the executor, then sampling, in turn
    for r in roots:
        kids = [s for s in spans if s.parent_id == r.span_id]
        assert [k.name for k in kids] == ["engine.schedule", "executor.step",
                                          "engine.sample"]
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("name", ["mistral-small-24b", "recurrentgemma-9b"])
def test_counts_match_the_executor(models, name):
    cfg, params = models[name]
    engine, tracer, reqs, _ = _traced(cfg, params)
    ex = engine.executor
    spans = list(tracer.spans)
    launch = [s for s in spans if s.name == "executor.launch"]
    assert sum(s.attrs["kind"] == "decode" for s in launch) \
        == ex.decode_steps > 0
    prefill = [s for s in launch if s.attrs["kind"] == "prefill"]
    assert len(prefill) == ex.prefill_passes
    assert sum(s.attrs["prompts"] for s in prefill) \
        == ex.prefill_computes == len(reqs)
    # a pass's phases carry its kind, a decode's launch also the bucket
    # replayed from a CUDA graph (0, eager, on the CPU), a prefill's launch
    # the prompts its pass computed; the rest carry none
    for s in spans:
        if s.name == "executor.launch" and s.attrs["kind"] == "decode":
            assert s.attrs == {"kind": "decode", "graph": 0}
        elif s.name == "executor.launch":
            assert s.attrs.keys() == {"kind", "prompts"}
            assert s.attrs["prompts"] >= 1
        elif s.name in ("executor.prepare", "executor.to_host"):
            assert s.attrs.keys() == {"kind"}
        else:
            assert s.attrs == {}
    # prepare, launch, to_host: once a pass, in turn, back to back
    for kind in ("decode", "prefill"):
        for name_ in ("executor.prepare", "executor.to_host"):
            assert sum(s.name == name_ and s.attrs["kind"] == kind
                       for s in spans) == sum(s.attrs["kind"] == kind
                                              for s in launch)
    for a, b, c in zip(*(
            [s for s in spans if s.name == n]
            for n in ("executor.prepare", "executor.launch",
                      "executor.to_host"))):
        assert a.end == b.start and b.end == c.start
        assert a.attrs["kind"] == b.attrs["kind"] == c.attrs["kind"]
        assert a.parent_id == b.parent_id == c.parent_id
    # a decode pass comes first in its step, before the step's prefills
    for step in {s.parent_id for s in launch}:
        kinds = [s.attrs["kind"] for s in launch if s.parent_id == step]
        assert kinds.count("decode") <= 1 and kinds == sorted(
            kinds, key=lambda k: k != "decode")


def test_chunk_that_computes_nothing_has_no_executor_spans(models):
    """A prompt of 100 in chunks of 16: six steps whose chunk computes
    nothing (an ``executor.step`` with no pass under it), then the prompt
    computed once on its last chunk."""
    cfg, params = models["mistral-small-24b"]
    engine = _engine(cfg, params, max_prefill_tokens=16)
    tracer = steptrace.attach(engine, steptrace.StepTracer())
    _serve(engine, _requests(cfg.vocab_size, (100,)))
    spans = list(tracer.spans)
    passes = {s.parent_id for s in spans if s.name == "executor.launch"}
    idle = [s for s in spans if s.name == "executor.step"
            and s.span_id not in passes]
    assert len(idle) == 6
    for name in ("executor.prepare", "executor.launch", "executor.to_host"):
        got = [s for s in spans if s.name == name
               and s.attrs["kind"] == "prefill"]
        assert len(got) == engine.executor.prefill_computes == 1
    # seven chunks, then the other tokens decoded one a step
    assert len([s for s in spans if s.name == "engine.step"]) == 7 + NEW - 1


@pytest.mark.parametrize("name", ["mistral-small-24b", "recurrentgemma-9b"])
def test_tokens_the_same_with_the_tracer_on_and_off(models, name):
    cfg, params = models[name]
    _, tracer, on, _ = _traced(cfg, params)
    off = _requests(cfg.vocab_size)
    engine = _engine(cfg, params)
    assert engine.tracer is None and engine.executor.tracer is None
    _serve(engine, off)
    assert len(tracer.spans) > 0
    assert [r.output_tokens for r in on] == [r.output_tokens for r in off]
    assert all(len(r.output_tokens) == NEW for r in on)


def test_spans_on_the_profilers_clock(models):
    """Every matmul of the window lies inside an ``executor.launch`` span
    once converted through the anchor, and every decode's launch span
    holds matmuls."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = models["mistral-small-24b"]
    engine = _engine(cfg, params)
    tracer = steptrace.attach(engine, steptrace.StepTracer())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(engine, _requests(cfg.vocab_size))
    mm = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name() in ("aten::mm", "aten::addmm", "aten::matmul")]
    launch = [(tracer.epoch_ns(s.start), tracer.epoch_ns(s.end), s.attrs)
              for s in tracer.spans if s.name == "executor.launch"]
    assert mm and launch
    tol = CLOCK_TOLERANCE_NS
    for a, b in mm:
        assert any(lo - tol <= a and b <= hi + tol for lo, hi, _ in launch)
    for lo, hi, attrs in launch:
        if attrs["kind"] == "decode":
            assert any(lo - tol <= a and b <= hi + tol for a, b in mm)


def _fail(*_):
    raise AssertionError("the clock was read")


@pytest.mark.parametrize("executor", ["sim", "real"])
def test_no_clock_read_with_no_tracer(models, monkeypatch, executor):
    cfg, params = models["mistral-small-24b"]
    if executor == "sim":
        engine = LLMEngine(cfg, SimExecutor(cfg, GPU_H100), num_blocks=64,
                           block_size=16, max_num_seqs=4,
                           max_prefill_tokens=64, max_model_len=256)
    else:
        engine = _engine(cfg, params)
    reqs = _requests(cfg.vocab_size)
    monkeypatch.setattr(time, "perf_counter_ns", _fail)
    assert _serve(engine, reqs) > 0
    assert all(len(r.output_tokens) == NEW for r in reqs)


def test_ring_drops_the_oldest_and_counts_them(models):
    cfg, params = models["mistral-small-24b"]
    engine = _engine(cfg, params)
    tracer = steptrace.attach(engine, steptrace.StepTracer(capacity=10))
    _serve(engine, _requests(cfg.vocab_size))
    made = tracer._next_id
    assert made > 10 and len(tracer.spans) == 10
    assert tracer.dropped == made - 10
    assert [s.span_id for s in tracer.spans] == list(range(made - 10, made))


def test_attach_detach_and_export(models):
    cfg, params = models["mistral-small-24b"]
    engine = _engine(cfg, params)
    tracer = steptrace.StepTracer()
    assert steptrace.attach(engine, tracer) is tracer
    assert engine.tracer is tracer and engine.executor.tracer is tracer
    _serve(engine, _requests(cfg.vocab_size, (12,)))
    steptrace.detach(engine)
    assert engine.tracer is None and engine.executor.tracer is None
    n = len(tracer.spans)
    _serve(engine, _requests(cfg.vocab_size, (12,)))
    assert len(tracer.spans) == n
    rows = tracer.to_dicts()
    assert [r["span_id"] for r in rows] == [s.span_id for s in tracer.spans]
    for r, s in zip(rows, tracer.spans):
        assert r["start"] == s.start - tracer.anchor[0] + tracer.anchor[1]
        assert r["end"] - r["start"] == s.end - s.start
        assert r["name"] == s.name and r["attrs"] == s.attrs
    # on the Unix-epoch clock, so within this test's run of now
    assert abs(rows[-1]["end"] - time.time_ns()) < 60e9


def test_step_that_raised_leaves_no_span_open(models):
    """A step whose executor raised leaves its spans open; the next step
    closes them as errors and records its own tree."""
    cfg, params = models["mistral-small-24b"]
    engine = _engine(cfg, params)
    tracer = steptrace.attach(engine, steptrace.StepTracer())
    real = engine.executor.step

    def broken(prefills, decode):
        engine.executor.step = real
        tracer.open("executor.step", tracer.now())
        raise RuntimeError("device lost")

    engine.executor.step = broken
    reqs = _requests(cfg.vocab_size, (12,))
    engine.add_request(reqs[0], 0.0)
    with pytest.raises(RuntimeError):
        engine.step(0.0)
    while engine.has_work():
        engine.step(0.0)
    bad = [s for s in tracer.spans if s.status == "error"]
    assert [s.name for s in bad] == ["engine.step", "executor.step"]
    assert all(s.end is not None for s in tracer.spans)
    assert len(reqs[0].output_tokens) == NEW
