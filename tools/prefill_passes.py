"""Readings of the port's packed prefill (``RealExecutor``: a step's
prompts on their last chunk computed together, in passes of at most the
engine's ``max_prefill_tokens`` prompt tokens) on the card, each in one
process. The benchmark runs none of it.

    python3 tools/prefill_passes.py share --workload qwen3-moe.chat \
        --seed <n> --seconds 51
        one untraced window of the cell, built, warmed and served as the
        benchmark does, with the program's step spans on: from the prefill
        ``executor.launch`` spans (one a pass, its ``prompts`` attribute the
        prompts it computed), the window's passes and prompts, the prompts
        a pass on average, the share of prompts computed in a pass with
        others and how many passes held each number of prompts; beside them
        the executor's ``prefill_passes`` and ``prefill_computes`` over the
        whole run (warm-up and lead-in included) and the cell's end-to-end
        metrics
    python3 tools/prefill_passes.py cost --workload qwen3-moe.chat \
        --seed <n> --passes 400 1600 400,400 400,400,400,400 400,1600
        the cell's engine alone (no traffic): for each item, one executor
        step over prompts of those lengths, each on its last chunk, with no
        decode; its host wall time (the step returns once the logits are on
        the host), the CUDA-event time between its start and end, and the
        device's busy time inside it (the kernels' and copies' durations
        from ``torch.profiler``, in one more step). Runs on any checkout
        whose executor takes the engine's step input, so the same command
        reads a checkout that computes one prompt a pass

Each prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, spec, stepspans  # noqa: E402


def out(**kw):
    print(json.dumps(kw), flush=True)


def packing(launches: list) -> dict:
    """The prefill passes' ``prompts`` attributes (one a pass) summed up:
    passes, prompts, prompts a pass, the share of prompts computed in a
    pass with others, and passes by their number of prompts."""
    prompts = sum(launches)
    return {"passes": len(launches), "prompts": prompts,
            "prompts_per_pass": prompts / len(launches) if launches else None,
            "packed_share": (sum(n for n in launches if n > 1) / prompts
                             if prompts else None),
            "passes_by_prompts": dict(sorted(
                collections.Counter(launches).items()))}


def share(setup, seconds, seed):
    engine = setup.engine()
    ex = engine.executor
    tracer = stepspans.attach(engine)
    harness.warm(setup, engine, seconds)
    win = harness.serve(setup, engine, seconds, seed)
    steps = stepspans.window_spans(tracer, win.t_start, win.seconds)
    # a launch span without the attribute computed one prompt
    launches = [s[3].get("prompts", 1) for p in steps
                for s in p.of("executor.launch", "prefill")]
    out(tool="share", cell=setup.cell.name, seed=seed,
        window=packing(launches),
        run_prefill_passes=getattr(ex, "prefill_passes", None),
        run_prefill_computes=ex.prefill_computes,
        dropped_spans=tracer.dropped,
        memory_peak_bytes=torch.cuda.max_memory_allocated(),
        end_to_end=harness.end_to_end(win))


def _busy_ms(fn) -> float:
    """Device ms of the kernels and copies of one call of ``fn``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6


def cost(setup, passes, repeats):
    engine = setup.engine()
    ex = engine.executor
    bs = setup.engine_kw["block_size"]
    vocab = setup.model.vocab_size
    rng = np.random.default_rng(setup.seed)
    for lens in passes:
        prefills, page = [], 0
        for n in lens:
            nb = -(-n // bs)
            prefills.append({"token_ids": rng.integers(1, vocab, n).tolist(),
                             "block_table": list(range(page, page + nb)),
                             "chunk": (0, n), "is_last": True, "slot": 0})
            page += nb

        def step():
            ex.step(prefills, None)

        passes0 = getattr(ex, "prefill_passes", None)
        step()                  # the shapes' first call, not timed
        host, event = [], []
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            a.record()
            step()
            z.record()
            host.append(1e3 * (time.perf_counter() - t))
            z.synchronize()
            event.append(a.elapsed_time(z))
        busy = _busy_ms(step)
        out(tool="cost", cell=setup.cell.name, prompts=list(lens),
            tokens=sum(lens),
            passes_a_step=(None if passes0 is None else
                           (ex.prefill_passes - passes0) / (repeats + 2)),
            host_ms=statistics.median(host), host_ms_all=host,
            event_ms=statistics.median(event), device_busy_ms=busy,
            memory_peak_bytes=torch.cuda.max_memory_allocated())


def _lengths(text):
    return [int(n) for n in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=("share", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--passes", type=_lengths, nargs="+",
                    default=[[400], [1600], [400, 400], [400] * 4,
                             [400, 1600]])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    setup = harness.Setup(spec.cell(args.workload), args.seed)
    out(device=torch.cuda.get_device_name(0))
    if args.tool == "share":
        share(setup, args.seconds, args.seed)
    else:
        cost(setup, args.passes, args.repeats)


if __name__ == "__main__":
    main()
