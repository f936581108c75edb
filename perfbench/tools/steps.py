"""Chip-side tool for the program's step spans (``repro_torch.engine.
steptrace``, read through ``perfbench/stepspans.py``), each in one process.
None of it is run by the benchmark's own runs.

    python3 perfbench/tools/steps.py traced --workload <cell> --seed <n> \
        --seconds 51
        one traced window (the device trace on) with a StepTracer attached:
        the cell's per-layer metrics and the step-span metrics, the checks
        that the spans agree with the harness's own and with the device
        trace, and the device's idle time by step phase
    python3 perfbench/tools/steps.py cost --workload <cell> --seed <n> \
        --seconds 51 --windows 6
        untraced windows on one seed, each on a fresh engine, with the
        tracer attached and without in the order on, off, off, on, ...:
        the harness's decode-step span and ``ttft_p90_ms`` of each, and
        the medians of either side (what the tracer costs when on)
    python3 perfbench/tools/steps.py spancost --steps 20000 --repeats 5
        the span calls of a decode-only step alone, in the order the
        engine and the executor make them, on a tracer whose ring fills:
        microseconds a step in each repeat, and the host memory a span
        holds (``tracemalloc``); needs no card

Each prints one JSON line per window (``spancost`` per repeat), and
``cost`` a last one with the medians.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import statistics
import sys
import time
import tracemalloc
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from perfbench import harness, spec, stepspans  # noqa: E402
from repro_torch.engine import steptrace  # noqa: E402

# the readers of the program's step spans (``metrics/<family>.py``)
FAMILIES = ("schedule_ms", "sample_ms", "queue_wait_p90_ms",
            "decode_prepare_ms", "decode_launch_ms", "to_host_ms",
            "to_host_copy_ms", "launch_idle_share")
PHASES = ("engine.schedule", "executor.prepare", "executor.launch",
          "executor.to_host", "engine.sample")


def out(**kw):
    print(json.dumps(kw), flush=True)


def step_metrics(cell) -> list:
    """The step-span metrics' names in ``cell``: each family with the
    cell's traffic as its suffix."""
    return [f"{f}.{cell.traffic_name}" for f in FAMILIES]


def read(win, names) -> dict:
    got = {}
    for name in names:
        v = spec.metric_reader(name)(win, name)
        if v is not None:
            got[name] = v
    return got


def _window(setup, seconds, seed, on: bool, trace: bool):
    """A window on a fresh engine, with a tracer attached when ``on``."""
    engine = setup.engine()
    tracer = stepspans.attach(engine) if on else None
    harness.warm(setup, engine, seconds)
    win = harness.serve(setup, engine, seconds, seed, trace=trace)
    if tracer is not None:
        win.spans = stepspans.window_spans(tracer, win.t_start, win.seconds)
    dropped = tracer.dropped if tracer is not None else None
    del engine, tracer
    harness.free(setup.device)
    return win, dropped


def checks(win) -> dict:
    """The program's spans against the harness's and the device trace."""
    steps = win.spans
    harness_ex = sum(s.e1 - s.e0 for s in win.steps)
    # each program step inside the harness's span of the same call
    t0s = [s.t0 for s in win.steps]
    matched = []
    for p in steps:
        i = bisect.bisect_right(t0s, p.start) - 1
        if i >= 0 and p.end <= win.steps[i].t1:
            matched.append(p)
    dec = [p for p in steps if p.decode_only]
    dec_ex = sum(p.total("executor.step") for p in dec)
    dec_parts = sum(p.total("executor.prepare", "decode")
                    + p.total("executor.launch", "decode")
                    + p.total("executor.to_host") for p in dec)
    got = {"program_steps": len(steps), "harness_steps": len(win.steps),
           "matched_steps": len(matched),
           "executor_over_harness": sum(p.total("executor.step")
                                        for p in matched) / harness_ex,
           "decode_only_steps": len(dec),
           "decode_executor_ms": 1e3 * dec_ex / max(1, len(dec)),
           "decode_parts_over_executor": dec_parts / dec_ex if dec_ex
           else None}
    if win.trace is not None:
        ex = sorted((a, b) for p in steps
                    for _, a, b, _ in p.of("executor.step"))
        inside = harness.busy_within(win.trace.intervals, ex)
        got["kernel_time_in_executor"] = inside / win.trace.busy_s
        # the step in flight when the window opened started before it, so
        # its span is not among the window's; count from the first one's
        got["kernel_time_in_executor_from_first_step"] = (
            inside / harness.busy_within(win.trace.intervals,
                                         [(ex[0][0], math.inf)]))
        idle = {}
        for name in PHASES:
            spans = sorted((a, b) for p in steps for _, a, b, _ in p.of(name))
            total = sum(b - a for a, b in spans)
            idle[name] = [total, total - harness.busy_within(
                win.trace.intervals, spans)]
        got["phase_s_and_idle_s"] = idle
    return got


def traced(setup, seconds, seed) -> dict:
    cell = setup.cell
    win, dropped = _window(setup, seconds, seed, on=True, trace=True)
    names = [m["name"] for m in cell.per_layer]
    names += [n for n in step_metrics(cell) if n not in names]
    row = dict(tool="traced", cell=cell.name, seed=seed, dropped=dropped,
               metrics=read(win, names), **checks(win),
               busy_s=win.trace.busy_s, window_s=win.trace.window_s)
    out(**row)
    return row


def cost(setup, seconds, seed, windows) -> dict:
    """``windows`` windows a side, in the order on, off, off, on, ..."""
    cell = setup.cell
    sides = {True: {"decode_step_ms": [], "ttft_p90_ms": []},
             False: {"decode_step_ms": [], "ttft_p90_ms": []}}
    for i in range(2 * windows):
        on = i % 4 in (0, 3)
        win, dropped = _window(setup, seconds, seed, on=on, trace=False)
        e2e = harness.end_to_end(win)
        row = {"decode_step_ms": spec.metric_reader("decode_step_ms")(
                   win, "decode_step_ms"),
               "ttft_p90_ms": e2e.get("ttft_p90_ms")}
        for k, v in row.items():
            sides[on][k].append(v)
        out(tool="cost", cell=cell.name, seed=seed, window=i, tracer=on,
            steps=len(win.steps), dropped=dropped, **row,
            step_metrics=read(win, step_metrics(cell)) if on else None)
    med = {f"{k}_{'on' if on else 'off'}": statistics.median(v)
           for on, side in sides.items() for k, v in side.items()}
    for k in ("decode_step_ms", "ttft_p90_ms"):
        med[f"{k}_on_over_off"] = med[f"{k}_on"] / med[f"{k}_off"]
    out(tool="cost", cell=cell.name, seed=seed, windows=windows, **med)
    return med


def _decode_step_spans(tracer):
    """The calls ``LLMEngine.step`` and ``RealExecutor.step`` / ``_decode``
    make on a tracer in a decode-only step."""
    t0 = tracer.now()
    tracer.begin(t0)
    tracer.span("engine.schedule", t0)
    tracer.open("executor.step", tracer.now())
    t = tracer.now()
    t = tracer.span("executor.prepare", t, kind="decode")
    t = tracer.span("executor.launch", t, kind="decode")
    tracer.span("executor.to_host", t, kind="decode")
    tracer.close()
    t1 = tracer.now()
    tracer.span("engine.sample", t1)
    tracer.close()


def spancost(steps, repeats) -> list:
    tracer = steptrace.StepTracer()
    rows = []
    for i in range(repeats):
        t = time.perf_counter_ns()
        for _ in range(steps):
            _decode_step_spans(tracer)
        rows.append(dict(tool="spancost", repeat=i, steps=steps,
                         us_a_step=(time.perf_counter_ns() - t) / steps / 1e3,
                         dropped=tracer.dropped))
        out(**rows[-1])
    # the host memory a span holds: a fresh ring that does not fill
    tracemalloc.start()
    tracer = steptrace.StepTracer(capacity=7 * steps)
    base = tracemalloc.get_traced_memory()[0]
    for _ in range(steps):
        _decode_step_spans(tracer)
    held = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    rows.append(dict(tool="spancost", spans=len(tracer.spans),
                     bytes_a_span=held / len(tracer.spans),
                     full_ring_mb=held / len(tracer.spans)
                     * steptrace.CAPACITY / 1e6))
    out(**rows[-1])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=("traced", "cost", "spancost"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.tool == "spancost":
        spancost(args.steps, args.repeats)
        return
    if args.workload is None:
        ap.error("traced and cost need --workload")
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    setup = harness.Setup(spec.cell(args.workload), args.seed)
    out(device=torch.cuda.get_device_name(0))
    if args.tool == "traced":
        traced(setup, args.seconds, args.seed)
    else:
        cost(setup, args.seconds, args.seed, args.windows)


if __name__ == "__main__":
    main()
