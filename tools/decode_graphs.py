"""Readings of the paged decode's CUDA graphs
(``repro_torch.engine.paged_model.PagedDecoder``, dense and moe) on the
card, each in one process. The benchmark runs none of it.

    python3 tools/decode_graphs.py share --workload mistral-24b.chat \
        --seed <n> --seconds 51
    python3 tools/decode_graphs.py share --workload qwen3-moe.chat \
        --seed <n> --seconds 51
        one untraced window of the cell, built, warmed and served as the
        benchmark does, with the program's step spans on: the share of the
        window's decodes replayed from a graph (decode ``executor.launch``
        spans whose ``graph`` attribute is a bucket, over all of them), the
        executor's ``graph_decodes`` over ``decode_steps`` for the whole run
        (warm-up and lead-in included), the seconds and the memory the
        engine's construction took (the captures, with the process's first
        decode pass), and the cell's end-to-end metrics
    python3 tools/decode_graphs.py padding --workload mistral-24b.chat \
        --seed <n> --sizes 45:48,64 65:80,96 200:224,256
    python3 tools/decode_graphs.py padding --workload qwen3-moe.chat \
        --seed <n> --sizes 18:24 30:32
        the cell's model and pool alone, its graphs built as the executor
        builds them: for each ``s:buckets``, a batch of s sequences at one
        context replayed in each bucket and decoded eagerly; the step's
        device time (CUDA events) and the paged kernels' (``paged_split``
        and ``paged_combine``, from ``torch.profiler``) with their share of
        the byte bound of the s real rows, as the benchmark's
        ``paged_attention_roofline`` counts it; for moe, beside them the
        grouped expert kernel's device time (``grouped_bf16`` /
        ``grouped_f32``), which a bucket's padding rows add to

Each prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, spec, stepspans, yardstick  # noqa: E402
from perfbench.metrics.moe_grouped_roofline import KERNELS  # noqa: E402
from repro_torch.engine import paged_model  # noqa: E402


def out(**kw):
    print(json.dumps(kw), flush=True)


def _memory():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def share(setup, seconds, seed):
    a0, r0 = _memory()
    t = time.perf_counter()
    engine = setup.engine()
    a1, r1 = _memory()
    build_s = time.perf_counter() - t
    ex = engine.executor
    pool = sum(v.numel() * v.element_size() for v in ex.pool.values())
    out(tool="share", engine_build_s=build_s,
        graphs=sorted(ex.decoder.graphs) if ex.paged else [],
        pool_bytes=pool, allocated_beyond_pool=a1 - a0 - pool,
        reserved_beyond_pool=r1 - r0 - pool)
    tracer = stepspans.attach(engine)
    harness.warm(setup, engine, seconds)
    win = harness.serve(setup, engine, seconds, seed)
    steps = stepspans.window_spans(tracer, win.t_start, win.seconds)
    launches = [s[3]["graph"] for p in steps
                for s in p.of("executor.launch", "decode")]
    replayed = sum(b > 0 for b in launches)
    out(tool="share", cell=setup.cell.name, seed=seed,
        window_decodes=len(launches), window_replayed=replayed,
        window_share=replayed / len(launches) if launches else None,
        buckets_used=sorted(set(launches)),
        run_decode_steps=ex.decode_steps, run_graph_decodes=ex.graph_decodes,
        dropped_spans=tracer.dropped,
        memory_peak_bytes=torch.cuda.max_memory_allocated(),
        end_to_end=harness.end_to_end(win))


def _batch(rng, s, ctx, bs, num_blocks, vocab):
    n = -(-ctx // bs)
    pages = rng.permutation(num_blocks)[:s * n].tolist()
    return {"slots": list(range(s)),
            "tokens": rng.integers(1, vocab, s).tolist(),
            "pos": [ctx - 1] * s,
            "block_tables": [pages[i * n:(i + 1) * n] for i in range(s)]}


def _device_ms(fn, n):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / n


def _kernel_ms(fn, n, groups):
    """Device ms a call of ``fn`` spends in each group of kernels (a tuple
    of name fragments), in the order of ``groups``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    return [sum(e.duration_ns() for e in events
                if any(k in e.name() for k in names)) / 1e6 / n
            for names in groups]


def padding(setup, sizes, ctx, repeats):
    cfg, kw, conf = setup.model, setup.engine_kw, setup.file
    bs, nb, cap = kw["block_size"], kw["num_blocks"], kw["max_num_seqs"]
    mb = -(-kw["max_model_len"] // bs)
    pool = paged_model.init_pool(cfg, nb + 1, bs, device="cuda")
    t = time.perf_counter()
    graphs = paged_model.PagedDecoder(setup.params, cfg, pool, cap, mb,
                                      scratch=nb)
    torch.cuda.synchronize()
    groups = [harness.PAGED_KERNELS]
    if cfg.family == "moe":
        groups.append(KERNELS)
    out(tool="padding", construct_s=time.perf_counter() - t,
        graphs=sorted(graphs.graphs))
    rng = np.random.default_rng(setup.seed)
    for s, buckets in sizes:
        if any(b not in graphs.graphs or b < s for b in buckets):
            sys.exit(f"buckets {buckets} for {s} rows: the ladder is "
                     f"{sorted(graphs.graphs)}")
        dec = _batch(rng, s, ctx, bs, nb, cfg.vocab_size)
        pages = sum(len(t) for t in dec["block_tables"])
        bound_ms = 1e3 * conf["num_hidden_layers"] * yardstick.paged_call_s(
            s, s * ctx, pages, conf["num_attention_heads"],
            conf["num_key_value_heads"], conf["head_dim"])
        bt = torch.zeros((s, mb), dtype=torch.int32)
        for i, table in enumerate(dec["block_tables"]):
            bt[i, :len(table)] = torch.tensor(table, dtype=torch.int32)
        args = (torch.tensor(dec["tokens"], device="cuda"),
                torch.tensor(dec["pos"], device="cuda"), bt.cuda())
        runs = {f"bucket_{b}": (lambda b=b: graphs.run(b, s), b)
                for b in buckets}
        runs["eager"] = (lambda: paged_model.decode_step(
            setup.params, cfg, *args[:2], pool, args[2]), s)
        for name, (fn, b) in runs.items():
            if name != "eager":
                graphs.stage(dec, b)
            step = _device_ms(fn, repeats)
            paged, *grouped = _kernel_ms(fn, repeats, groups)
            out(tool="padding", s=s, ctx=ctx, run=name, rows=b,
                step_device_ms=step, paged_device_ms=paged,
                paged_bound_ms=bound_ms,
                paged_roofline=100.0 * bound_ms / paged,
                **({"grouped_device_ms": grouped[0]} if grouped else {}))


def _sizes(text):
    s, buckets = text.split(":")
    return int(s), [int(b) for b in buckets.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=("share", "padding"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--sizes", type=_sizes, nargs="+",
                    default=[(45, [48, 64]), (65, [80, 96])])
    ap.add_argument("--ctx", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    setup = harness.Setup(spec.cell(args.workload), args.seed)
    out(device=torch.cuda.get_device_name(0))
    if args.tool == "share":
        share(setup, args.seconds, args.seed)
    else:
        padding(setup, args.sizes, args.ctx, args.repeats)


if __name__ == "__main__":
    main()
