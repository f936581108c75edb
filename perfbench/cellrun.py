"""One run of one cell: set-up, warm-up, the window, the result line and the
check of what was served. ``run.py`` calls it on the card after looking for
one; the tests call it on the CPU with a reduced model.
"""
from __future__ import annotations

import sys
import time

import torch

from perfbench import check, harness, spec


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, log, model=None):
    """The result line of one run (a dict), or None when a module of the
    JAX side was loaded by the time the window closed."""
    setup = harness.Setup(cell, seed, device, model)
    engine = setup.engine()
    harness.warm(setup, engine, seconds)
    win = harness.serve(setup, engine, seconds, seed, trace)
    setup_s = win.t_start - t_process

    bad = harness.forbidden_modules()
    if bad:
        log(error="modules of the JAX side loaded in the run", modules=bad)
        return None
    cuda = setup.device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(setup.device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(setup.device)
           if cuda else 0}

    e2e = harness.end_to_end(win)
    e2e["setup_s"] = setup_s
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(win, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    _log_counters(log, engine, win, e2e)

    sent = win.requests + win.lead
    served = [(r.prompt, list(r.req.output_tokens), r.done is not None)
              for r in sent]
    del engine
    harness.free(setup.device)
    t0 = time.perf_counter()
    want = cell.params["check"]
    pick = check.sample(served, seed, want["requests"], want["served_tokens"])
    got = check.gaps(setup.params, setup.file, served, pick) if pick else {}
    log(check_seconds=time.perf_counter() - t0, **got)
    compared = {k: {"value": got.get(k, float("inf")), "limit": v}
                for k, v in want["limits"].items()}
    correct = bool(pick) and all(c["value"] <= c["limit"]
                                 for c in compared.values())

    line = {"correct": correct, "attempted": len(sent),
            "failed": sum(r.failed for r in sent),
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": harness.device_ops(win),
                             "idle_gaps": harness.idle_gaps(win)}
    line["checks"] = compared
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    return line


def _log_counters(log, engine, win, e2e):
    """The program's own counters and the window's records behind the
    metrics, on standard error."""
    ex, m, alloc = engine.executor, engine.metrics, engine.allocator
    late = [r.added - r.due for r in win.requests if r.added >= r.due]
    log(window_s=win.seconds, steps=len(win.steps),
        decode_steps=ex.decode_steps, prefill_computes=ex.prefill_computes,
        tokens_generated=m.tokens_generated,
        tokens_prefilled=m.tokens_prefilled, preemptions=m.preemptions,
        prefix_hits=alloc.prefix_hits, prefix_queries=alloc.prefix_queries,
        requests=len(win.requests), lead_in_requests=len(win.lead),
        finished=sum(r.done is not None for r in win.requests),
        with_token=sum(r.first is not None for r in win.requests),
        waiting_at_end=win.waiting[-1][1] if win.waiting else 0,
        running_at_end=win.waiting[-1][2] if win.waiting else 0,
        lateness_max_s=max(late, default=0.0),
        lateness_mean_s=sum(late) / len(late) if late else 0.0,
        end_to_end=e2e)
