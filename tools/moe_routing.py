"""Readings of the MoE layer's routing on the card, from the grouped expert
GEMM's device counters (``repro_torch.kernels.moe_grouped.kernel``), in one
process. The benchmark runs none of it.

    python3 tools/moe_routing.py --workload qwen3-moe.chat --seed <n> \
        --seconds 51

one untraced run of the cell, built, warmed and served as the benchmark
does, with the kernel's one accumulator split by pass on the card: a copy
of it is taken before each decode pass and each prefill, and the
difference after the pass is added to that kind's tally (no
synchronisation, nothing read inside the window; a CUDA graph's replay adds
to the accumulator whose address its capture froze, so the accumulator
stays in place). Both tallies are read once, after the window, over the
lead-in and the window: per kind the calls (one a MoE layer a pass), the
routed rows (n x k a call), the experts with at least one row per call,
and the padding share (the rows the kernel's 64-row tiles add, over all
rows it computes); beside them the executor's host counters ``moe_calls``
and ``moe_rows`` and its ``graph_padding_rows``: the calls must equal
``moe_calls``, and the rows ``moe_rows`` with each padding row of a
replayed decode's bucket routed too (its k rows in every layer); then the
cell's end-to-end metrics.

Prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from perfbench import harness, spec  # noqa: E402
from repro_torch.kernels.moe_grouped import kernel  # noqa: E402


def out(**kw):
    print(json.dumps(kw), flush=True)


def split_by_pass(executor, device: int) -> dict:
    """Gives decode passes and prefills a tally each, on the card: around a
    pass, the kernel's accumulator's growth is added to its kind's."""
    acc = kernel.counter(device)
    tallies = {kind: torch.zeros_like(acc) for kind in ("decode", "prefill")}
    for kind, name in (("decode", "_decode"), ("prefill", "_prefill")):
        inner = getattr(executor, name)

        def wrapped(arg, inner=inner, tally=tallies[kind]):
            before = acc.clone()
            out = inner(arg)
            tally.add_(acc - before)
            return out
        setattr(executor, name, wrapped)
    return tallies


def summary(acc) -> dict:
    c = dict(zip(kernel.COUNTERS, acc.tolist()))
    calls = c["calls"]
    rows = c["routed_rows"] + c["padding_rows"]
    return {**c,
            "rows_per_call": c["routed_rows"] / calls if calls else None,
            "experts_per_call": c["experts_touched"] / calls if calls else None,
            "padding_share": c["padding_rows"] / rows if rows else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    setup = harness.Setup(spec.cell(args.workload), args.seed)
    out(device=torch.cuda.get_device_name(0))
    engine = setup.engine()
    harness.warm(setup, engine, args.seconds)
    ex = engine.executor
    calls0, rows0 = ex.moe_calls, ex.moe_rows
    padding0 = ex.graph_padding_rows
    tallies = split_by_pass(ex, setup.device.index or 0)
    win = harness.serve(setup, engine, args.seconds, args.seed)
    torch.cuda.synchronize()
    kinds = {kind: summary(t) for kind, t in tallies.items()}
    padding = ex.graph_padding_rows - padding0
    cfg = setup.model
    out(tool="moe_routing", cell=args.workload, seed=args.seed, **kinds,
        host_moe_calls=ex.moe_calls - calls0,
        host_moe_rows=ex.moe_rows - rows0,
        graph_padding_rows=padding,
        host_rows_with_padding=ex.moe_rows - rows0 + padding
        * cfg.num_experts_per_tok * cfg.num_layers,
        device_calls=sum(k["calls"] for k in kinds.values()),
        device_rows=sum(k["routed_rows"] for k in kinds.values()),
        end_to_end=harness.end_to_end(win))


if __name__ == "__main__":
    main()
