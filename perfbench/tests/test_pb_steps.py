"""The readers of the program's step spans on synthetic windows, their
silence where a window has no spans (a program before them), the spans put
on the harness's timeline, and the traced rehearsal of ``tools/steps.py``
on the CPU, which reports every one of them."""
from types import SimpleNamespace

import pytest

from perfbench import harness, spec, stepspans
from perfbench.tests.conftest import reduced_cell
from perfbench.tools import steps as steps_tool
from repro_torch.engine import steptrace

STEP_METRICS = [f"{f}.chat" for f in steps_tool.FAMILIES]


def _step(t0, parts, **attrs):
    """A StepSpans from (name, start, end, attrs) rows, starting at t0."""
    end = max([t0] + [b for _, _, b, _ in parts])
    return stepspans.StepSpans(t0, end, attrs, list(parts))


def _decode_step(t0, prepare, launch, to_host):
    a = t0 + 0.001
    return _step(t0, [
        ("engine.schedule", t0, a, {}),
        ("executor.step", a, a + prepare + launch + to_host, {}),
        ("executor.prepare", a, a + prepare, {"kind": "decode"}),
        ("executor.launch", a + prepare, a + prepare + launch,
         {"kind": "decode"}),
        ("executor.to_host", a + prepare + launch,
         a + prepare + launch + to_host, {"kind": "decode"}),
        ("engine.sample", a + prepare + launch + to_host,
         a + prepare + launch + to_host + 0.002, {})])


def _window(spans=None, intervals=(), requests=()):
    win = harness.Window(spec.cell("mistral-24b.chat"), 10.0)
    win.requests = list(requests)
    if spans is not None:
        win.spans = spans
    win.trace = harness.Trace(sum(b - a for a, b in intervals), 10.0, {},
                              [list(i) for i in intervals])
    return win


def _read(name, win):
    return spec.metric_reader(name)(win, name)


def test_readers_on_a_synthetic_window():
    d1 = _decode_step(0.0, 0.001, 0.050, 0.010)
    d2 = _decode_step(1.0, 0.003, 0.070, 0.030)
    # a step with a decode and a prefill pass: not decode-only
    mixed = _step(2.0, [
        ("engine.schedule", 2.0, 2.002, {}),
        ("executor.step", 2.002, 2.3, {}),
        ("executor.prepare", 2.002, 2.003, {"kind": "decode"}),
        ("executor.launch", 2.003, 2.1, {"kind": "decode"}),
        ("executor.to_host", 2.1, 2.11, {"kind": "decode"}),
        ("executor.prepare", 2.11, 2.12, {"kind": "prefill"}),
        ("executor.launch", 2.12, 2.2, {"kind": "prefill"}),
        ("executor.to_host", 2.2, 2.3, {"kind": "prefill"}),
        ("engine.sample", 2.3, 2.31, {})])
    steps = [d1, d2, mixed]
    # the device busy for the first 20 ms of each decode-only launch
    busy = [(s.of("executor.launch")[0][1], s.of("executor.launch")[0][1]
             + 0.020) for s in (d1, d2)]
    win = _window(steps, busy)
    assert _read("schedule_ms.chat", win) == pytest.approx(
        1e3 * (0.001 + 0.001 + 0.002) / 3)
    assert _read("sample_ms.chat", win) == pytest.approx(
        1e3 * (0.002 + 0.002 + 0.01) / 3)
    assert _read("decode_prepare_ms.chat", win) == pytest.approx(2.0)
    assert _read("decode_launch_ms.chat", win) == pytest.approx(60.0)
    assert _read("to_host_ms.chat", win) == pytest.approx(
        1e3 * (0.010 + 0.030 + 0.010 + 0.100) / 3)
    assert _read("to_host_copy_ms.chat", win) == 0.0
    win.trace.kernels["Memcpy DtoH (Device -> Pageable)"] = [0.006, 3]
    win.trace.kernels["Memcpy HtoD (Pageable -> Device)"] = [0.5, 9]
    assert _read("to_host_copy_ms.chat", win) == pytest.approx(2.0)
    launch_s = 0.050 + 0.070 + 0.097 + 0.08
    assert _read("launch_idle_share.chat", win) == pytest.approx(
        100.0 * (1 - 0.040 / launch_s))


def _tracked(added, admitted):
    metrics = SimpleNamespace(first_scheduled_time=admitted)
    return SimpleNamespace(added=added, req=SimpleNamespace(metrics=metrics))


def test_queue_wait_counts_an_unadmitted_request_with_its_age():
    reqs = [_tracked(1.0, 1.1), _tracked(2.0, 2.5), _tracked(9.0, None),
            _tracked(3.0, 3.0)] + [_tracked(4.0, 4.2)] * 6
    win = _window(requests=reqs)
    waits = [0.1, 0.5, 1.0, 0.0] + [0.2] * 6
    from perfbench import yardstick
    assert _read("queue_wait_p90_ms.chat", win) == pytest.approx(
        1e3 * yardstick.percentile(waits, 90))
    assert _read("queue_wait_p90_ms.chat", _window()) is None


@pytest.mark.parametrize("name", STEP_METRICS[:2] + STEP_METRICS[3:])
def test_readers_are_silent_without_spans(name):
    """A window without the program's spans (the harness sets none, and a
    program before them has none) reads nothing and raises nothing."""
    assert _read(name, _window()) is None
    assert _read(name, _window(spans=[])) is None


def test_attach_puts_one_tracer_on_the_engine_and_its_executor():
    engine = SimpleNamespace(executor=SimpleNamespace())
    tracer = stepspans.attach(engine)
    assert engine.tracer is tracer and engine.executor.tracer is tracer
    assert len(tracer.spans) == 0


def test_spancost_makes_the_spans_of_a_decode_step():
    """The microbenchmark's calls make one decode-only step's tree, as the
    engine and the executor do."""
    rows = steps_tool.spancost(steps=50, repeats=2)
    assert [r["steps"] for r in rows[:2]] == [50, 50]
    assert rows[-1]["spans"] == 7 * 50 and rows[-1]["bytes_a_span"] > 0
    tracer = steptrace.StepTracer()
    steps_tool._decode_step_spans(tracer)
    (step,) = stepspans.window_spans(tracer, 0.0, 1e12)
    assert step.decode_only and step.attrs == {}
    assert [n for n, *_ in step.spans] == [
        "engine.schedule", "executor.step", "executor.prepare",
        "executor.launch", "executor.to_host", "engine.sample"]


def test_pairs_alternate_which_side_runs_first():
    from perfbench.tools import pairs
    assert pairs.order([1, 2, 3]) == [
        ("parent", 1), ("change", 1), ("change", 2), ("parent", 2),
        ("parent", 3), ("change", 3)]


def test_window_spans_on_the_harness_clock():
    from repro_torch.core.tracing import Span
    t_start = 100.0
    tracer = SimpleNamespace(spans=[])

    def add(i, parent, name, a, b, **attrs):
        s = Span(i, parent, name, int((t_start + a) * 1e9), attrs)
        s.end = None if b is None else int((t_start + b) * 1e9)
        tracer.spans.append(s)

    add(0, None, "engine.step", -0.5, -0.4)     # before the window
    add(1, 0, "engine.schedule", -0.5, -0.49)
    add(2, None, "engine.step", 0.1, 0.3)
    add(3, 2, "executor.step", 0.11, 0.29)
    add(4, 3, "executor.launch", 0.12, 0.2, kind="decode")
    add(5, 7, "executor.to_host", 0.2, 0.21)    # its step was dropped
    add(6, None, "engine.step", 9.9, None)      # still open
    add(8, None, "engine.step", 10.0, 10.1)     # after the window
    got = stepspans.window_spans(tracer, t_start, 10.0)
    assert len(got) == 1
    s = got[0]
    assert (s.start, s.end) == pytest.approx((0.1, 0.3))
    assert s.attrs == {}
    assert [n for n, *_ in s.spans] == ["executor.step", "executor.launch"]
    assert s.decode_only and s.total("executor.launch", "decode") \
        == pytest.approx(0.08)


def test_traced_rehearsal_reports_every_step_metric():
    """``tools/steps.py traced`` on the CPU at reduced sizes: the seven
    metrics read, the program's spans agree with the harness's and hold
    the trace's work (the CPU's ops stand in for the kernels)."""
    cell, model = reduced_cell("mistral-24b.chat")
    setup = harness.Setup(cell, 2**31 + 23, "cpu", model)
    row = steps_tool.traced(setup, 4.0, 2**31 + 23)
    assert set(STEP_METRICS) <= set(row["metrics"])
    assert {m["name"] for m in cell.per_layer} - {
        "paged_attention_roofline.chat", "flash_prefill_roofline"} \
        <= set(row["metrics"])
    assert row["dropped"] == 0
    assert row["matched_steps"] == row["program_steps"] \
        == row["harness_steps"] > 0
    assert 0.95 <= row["executor_over_harness"] <= 1.0
    assert 0.95 <= row["decode_parts_over_executor"] <= 1.0
    assert 0.99 <= row["kernel_time_in_executor_from_first_step"] <= 1.0
    assert row["kernel_time_in_executor"] \
        <= row["kernel_time_in_executor_from_first_step"]
    m = row["metrics"]
    assert m["schedule_ms.chat"] + m["sample_ms.chat"] \
        <= m["engine_host_ms.chat"]
    assert 0 <= m["launch_idle_share.chat"] <= 100


def test_traced_run_line_reports_queue_wait():
    """The one step metric that needs no program spans, through the
    harness's own traced run."""
    from perfbench.tests.conftest import run_cpu
    line, _ = run_cpu("mistral-24b.chat", trace=True)
    assert line["metrics"]["queue_wait_p90_ms.chat"]["value"] >= 0
    assert line["metrics"]["queue_wait_p90_ms.chat"]["unit"] == "ms"
