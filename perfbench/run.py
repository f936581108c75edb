"""Run one cell of the benchmark once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found by name under ``perfbench/``. The weights and the traffic come from
``--seed``. Set-up builds the kernels into ``build/kernels/`` in the
checkout (once), draws the weights on the card, builds the engine,
serves a short slice of the cell's traffic on it and then the cell's
lead-in, which brings it to the cell's load; then the window serves the
cell's traffic for ``--seconds`` on the wall clock. After it, a sample of
what was served is checked against the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def log(**kw):
    print(json.dumps(kw), file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec
    cell = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s), found "
              f"{have}: no result", file=sys.stderr)
        return 2
    from perfbench import cellrun
    line = cellrun.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_PROCESS, log)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
