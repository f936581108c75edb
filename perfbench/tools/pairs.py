"""Parent against change: the benchmark's command in two checkouts, one
process a run, in the order parent, change, change, parent, parent, change,
... (each pair on one seed), then, with ``--traced-seed``, one traced run
on each side.

    python3 perfbench/tools/pairs.py --parent <dir> --change <dir> \
        --workload <cell> --seeds 1,2,3 --seconds 51 [--traced-seed 4]

Each checkout runs its own ``perfbench/run.py``. Prints one JSON line a
run: side, seed, trace, exit code, wall seconds and the run's result line
(``metrics``, ``correct``, ``attempted``, ``failed``); the last 40 lines of
each run's standard error go to ``--log`` (default
``chiprun_out/pairs.log``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def order(seeds: list) -> list:
    """(side, seed) in turn: the first pair parent first, the next change
    first, and so on."""
    runs = []
    for i, seed in enumerate(seeds):
        sides = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        runs += [(side, seed) for side in sides]
    return runs


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        log) -> dict:
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(int(trace))],
        cwd=root, capture_output=True, text=True)
    row = {"rc": p.returncode, "wall_s": time.perf_counter() - t}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        line = json.loads(lines[-1])
        row.update({k: line.get(k) for k in
                    ("correct", "attempted", "failed", "metrics")})
    log.write(f"== {root} seed {seed} trace {int(trace)} rc "
              f"{p.returncode}\n")
    log.write("\n".join(p.stderr.splitlines()[-40:]) + "\n")
    log.flush()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", required=True, type=Path)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--traced-seed", type=int)
    ap.add_argument("--log", type=Path, default=Path("chiprun_out/pairs.log"))
    args = ap.parse_args(argv)
    roots = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = [(side, seed, False) for side, seed in order(args.seeds)]
    if args.traced_seed is not None:
        runs += [(side, args.traced_seed, True)
                 for side in ("parent", "change")]
    args.log.parent.mkdir(parents=True, exist_ok=True)
    with open(args.log, "a") as log:
        for side, seed, trace in runs:
            row = run(roots[side], args.workload, seed, args.seconds, trace,
                      log)
            print(json.dumps({"side": side, "seed": seed,
                              "trace": int(trace), **row}), flush=True)


if __name__ == "__main__":
    main()
