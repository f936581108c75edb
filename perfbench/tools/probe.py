"""Chip-side tools for defining a cell, each in one process so that the
set-up is paid once. None of them is run by the benchmark's own runs.

    python3 perfbench/tools/probe.py memory --workload <cell>
        free memory after the weights, and the largest step's peak (the
        cell's warm-up, which holds its longest prompt): what num_blocks
        can be
    python3 perfbench/tools/probe.py sweep --workload <cell> \
        --rates 1,2,3 --seconds 30
        one open-loop window per rate, each on a fresh engine: whether the
        waiting queue grows through the window (the knee)
    python3 perfbench/tools/probe.py calibrate --workload <cell> \
        --seeds 1,2,3 --control 3 --seconds 45
        per seed, a window at the cell's load and the check's reading;
        for the first ``--control`` seeds also the float8 control's: the
        two readings the limit is set between
    python3 perfbench/tools/probe.py repeat --workload <cell> \
        --seeds 1,1,2 --seconds 45
        windows at the cell's load, seeds repeated as given, no check:
        the spread of the end-to-end numbers
    python3 perfbench/tools/probe.py witness --config qwen3-moe \
        --seeds 1,2 --short 8 --short-len 48 --long-len 600 --out 150
        a configuration's program against the reference, short prompts
        and long ones apart (not a cell: no window); with --cpu on the
        CPU at the program's reduced sizes in float32

Each prints one JSON line per window on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from perfbench import check, harness, spec, traffic  # noqa: E402


def out(**kw):
    print(json.dumps(kw), flush=True)


def memory(cell, args):
    setup = harness.Setup(cell, args.seed)
    torch.cuda.synchronize()
    free_b, total_b = torch.cuda.mem_get_info()
    weights_b = torch.cuda.memory_allocated()
    pool_bytes = (2 * cell.config["num_hidden_layers"]
                  * cell.config["block_size"]
                  * cell.config["num_key_value_heads"]
                  * cell.config["head_dim"] * 4)
    setup.engine_kw["num_blocks"] = args.blocks   # a pool that surely fits
    engine = setup.engine()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    harness.warm(setup, engine, args.seconds)
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.memory_reserved()
    out(tool="memory", cell=cell.name, total_bytes=total_b,
        free_after_weights_bytes=free_b, weights_bytes=weights_b,
        pool_block_bytes=pool_bytes,
        probe_blocks=args.blocks,
        step_peak_over_pool_bytes=peak, reserved_bytes=reserved,
        blocks_that_fit=(free_b - peak) // pool_bytes)


def _host_ms():
    """A fixed pure-Python loop, timed: the host's speed at this moment."""
    t0 = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return 1e3 * (time.perf_counter() - t0)


def _thirds(win, seconds):
    """Per third of the window: the waiting queue and the requests in
    flight (means over steps), and the decode-only steps' mean executor
    span and batch."""
    out = {}
    for part in range(3):
        lo, hi = part * seconds / 3, (part + 1) * seconds / 3
        rows = [x for x in win.waiting if lo <= x[0] < hi]
        out[f"waiting_mean_third{part + 1}"] = (
            sum(x[1] for x in rows) / max(1, len(rows)))
        out[f"in_flight_mean_third{part + 1}"] = (
            sum(x[1] + x[2] for x in rows) / max(1, len(rows)))
        dec = [s for s in win.steps
               if lo <= s.t0 < hi and s.decode_seqs and not s.prefills]
        out[f"decode_ms_third{part + 1}"] = (
            1e3 * sum(s.e1 - s.e0 for s in dec) / max(1, len(dec)))
        out[f"decode_batch_third{part + 1}"] = (
            sum(s.decode_seqs for s in dec) / max(1, len(dec)))
    return out


def _window(setup, seconds, seed, rate=None):
    engine = setup.engine()
    harness.warm(setup, engine, seconds)
    host = _host_ms()
    win = harness.serve(setup, engine, seconds, seed, rate=rate)
    served = [(r.prompt, list(r.req.output_tokens), r.done is not None)
              for r in win.requests + win.lead]
    rows = dict(host_loop_ms=host, steps=len(win.steps),
                requests=len(win.requests),
                finished=sum(r.done is not None for r in win.requests),
                waiting_max=max((x[1] for x in win.waiting), default=0),
                **_thirds(win, seconds), **harness.end_to_end(win))
    del engine, win
    harness.free("cuda")
    return served, rows


def sweep(cell, args):
    setup = harness.Setup(cell, args.seed)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        _, rows = _window(setup, args.seconds, args.seed + i, rate)
        out(tool="sweep", cell=cell.name, rate=rate, **rows)


def calibrate(cell, args):
    seeds = [int(s) for s in args.seeds.split(",")]
    setup = harness.Setup(cell, seeds[0])
    for i, seed in enumerate(seeds):
        if i:
            setup.reseed(seed)
        served, rows = _window(setup, args.seconds, seed)
        want = cell.params["check"]
        pick = check.sample(served, seed, want["requests"],
                            want["served_tokens"])
        t0 = time.perf_counter()
        got = check.gaps(setup.params, setup.file, served, pick,
                         control=i < args.control)
        out(tool="calibrate", cell=cell.name, seed=seed,
            check_s=time.perf_counter() - t0, **got, **rows)
        harness.free("cuda")


def repeat(cell, args):
    """Windows on the seeds given (repeats allowed), no check: the
    end-to-end numbers of each, for their spread."""
    seeds = [int(s) for s in args.seeds.split(",")]
    setup = harness.Setup(cell, seeds[0])
    for seed in seeds:
        if seed != setup.seed:
            setup.reseed(seed)
        _, rows = _window(setup, args.seconds, seed)
        out(tool="repeat", cell=cell.name, seed=seed, **rows)


def witness(args):
    """A configuration's program against the reference by prompt length:
    per seed, ``--short`` prompts of ``--short-len`` tokens and as many of
    ``--long-len``, each with ``--out`` greedy tokens, sent at once on a
    fresh engine and served to the end; then each group's served tokens
    against the reference, with the float8 control. Where the two groups
    read apart, the prompt length is what the program does differently.
    ``--cpu``: on the CPU, at the program's reduced sizes, in float32."""
    seeds = [int(s) for s in args.seeds.split(",")]
    conf = spec.load_json(spec.HERE / "configs" / f"{args.config}.json")
    cell = spec.Cell(name=args.config, chips=1, config_name=args.config,
                     config=conf, traffic_name="", traffic={}, params={},
                     end_to_end=[], per_layer=[])
    if args.cpu:
        from repro_torch.config import ModelConfig
        model = ModelConfig(**spec.model_kwargs(conf, args.config)).reduced()
        setup = harness.Setup(cell, seeds[0], "cpu", dataclasses.replace(
            model, param_dtype="float32"))
    else:
        setup = harness.Setup(cell, seeds[0])
    lengths = [args.short_len] * args.short + [args.long_len] * args.short
    for seed in seeds:
        if seed != setup.seed:
            setup.reseed(seed)
        engine = setup.engine()
        prompts = traffic.tokens(seed, lengths, setup.model.vocab_size)
        reqs = [harness._request(traffic.Item(n, args.out), p)
                for n, p in zip(lengths, prompts)]
        for r in reqs:
            engine.add_request(r, 0.0)
        while engine.has_work():
            engine.step(0.0)
        served = [(p, list(r.output_tokens), True)
                  for p, r in zip(prompts, reqs)]
        del engine, reqs
        harness.free(setup.device)
        for name, pick in (("short", range(args.short)),
                           ("long", range(args.short, len(lengths)))):
            got = check.gaps(setup.params, setup.file, served, list(pick),
                             control=True)
            out(tool="witness", config=args.config, seed=seed, prompts=name,
                prompt_len=lengths[pick[0]], **got)
            harness.free(setup.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=("memory", "sweep", "calibrate",
                                     "repeat", "witness"))
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--short", type=int, default=8)
    ap.add_argument("--short-len", type=int, default=48)
    ap.add_argument("--long-len", type=int, default=600)
    ap.add_argument("--out", type=int, default=150)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--blocks", type=int, default=2048)
    args = ap.parse_args(argv)
    if args.tool == "witness":
        return witness(args)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cell = spec.cell(args.workload)
    {"memory": memory, "sweep": sweep, "calibrate": calibrate,
     "repeat": repeat}[args.tool](cell, args)


if __name__ == "__main__":
    main()
