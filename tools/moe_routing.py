"""Readings of the MoE layer's routing on the card, from the grouped expert
GEMM's device counters (``repro_torch.kernels.moe_grouped.kernel``), in one
process. The benchmark runs none of it.

    python3 tools/moe_routing.py --workload qwen3-moe.chat --seed <n> \
        --seconds 51

one untraced run of the cell, built, warmed and served as the benchmark
does, with one accumulator for decode passes and one for prefills put in
place of the kernel's own (each pass swaps its own in first: no
synchronisation, nothing read inside the window). Both are read once, after
the window, over the lead-in and the window: per kind the calls (one a MoE
layer a pass), the routed rows (n x k a call), the experts with at least one
row per call, and the padding share (the rows the kernel's 64-row tiles
add, over all rows it computes); beside them the executor's host counters
``moe_calls`` and ``moe_rows``, which the two sums must equal, and the
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
    """Gives decode passes and prefills an accumulator each: before a pass,
    its kind's is put where the kernel looks for the device's."""
    accs = {kind: torch.zeros(len(kernel.COUNTERS), dtype=torch.int64,
                              device=f"cuda:{device}")
            for kind in ("decode", "prefill")}
    for kind, name in (("decode", "_decode"), ("prefill", "_prefill")):
        inner = getattr(executor, name)

        def wrapped(arg, inner=inner, acc=accs[kind]):
            kernel.counters[device] = acc
            return inner(arg)
        setattr(executor, name, wrapped)
    return accs


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
    accs = split_by_pass(ex, setup.device.index or 0)
    win = harness.serve(setup, engine, args.seconds, args.seed)
    torch.cuda.synchronize()
    kinds = {kind: summary(acc) for kind, acc in accs.items()}
    out(tool="moe_routing", cell=args.workload, seed=args.seed, **kinds,
        host_moe_calls=ex.moe_calls - calls0,
        host_moe_rows=ex.moe_rows - rows0,
        device_calls=sum(k["calls"] for k in kinds.values()),
        device_rows=sum(k["routed_rows"] for k in kinds.values()),
        end_to_end=harness.end_to_end(win))


if __name__ == "__main__":
    main()
