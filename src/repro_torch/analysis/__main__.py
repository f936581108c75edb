"""CLI: ``python -m repro_torch.analysis [paths] [--check-goldens tests/]``.

Emits one ``file:line: RULE message`` row per finding and exits nonzero
when any survive suppression — the blocking CI lint gate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.lint import lint_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: determinism + wire-contract static "
                    "analysis over the sim-executed modules")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--check-goldens", metavar="TESTS_DIR", default=None,
                    help="also cross-check the GOLDEN status table in "
                         "TESTS_DIR/test_api.py against the taxonomy")
    args = ap.parse_args(argv)
    paths = [Path(p) for p in (args.paths or ["src/repro_torch"])]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"repro-lint: no such path: {missing[0]}", file=sys.stderr)
        return 2
    goldens = Path(args.check_goldens) if args.check_goldens else None
    findings = lint_paths(paths, goldens_dir=goldens)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"repro-lint: {n} finding{'s' if n != 1 else ''}"
          + ("" if n else " (clean)"), file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
