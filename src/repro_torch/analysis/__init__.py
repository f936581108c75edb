"""repro-lint: static determinism/contract analysis for the sim stack.

The simulation's determinism claim (`repro_torch.core.simclock`) underwrites
every A/B number in benchmarks/; this package enforces it mechanically
with AST-level invariant checks over the sim-executed modules
(``core/``, ``engine/``, ``api/``, ``data/``):

* **R1** — no wall-clock reads or unseeded randomness in sim code
* **R2** — no order-sensitive iteration over unordered sets
* **R3** — closures scheduled on the EventLoop that capture
  endpoint/instance/request-ish objects must re-check liveness
  (the zombie-closure rule; see the PR-6 zombie-endpoint bug)
* **R4** — status-code taxonomy and metric-key cross-checks
  (dead/dangling metric and untabulated-status detection)
* **R5** — span handles bound from ``Tracer.start_span`` must be closed
  on all code paths or handed off (the span-leak rule; ``core/`` only)
* **R6** — every series the scrape/telemetry layer emits must be
  declared in ``core/telemetry.METRIC_REGISTRY`` (the unregistered-
  emission rule, the inverse of R4's dangling-metric check)
* **LINT** — suppression hygiene (a suppression must carry a reason)

CLI: ``python -m repro_torch.analysis [paths] [--check-goldens tests/]`` —
prints ``file:line: RULE message`` findings, exits nonzero on any.

Suppressions, line-level, reason mandatory::

    x = hash(k)  # repro-lint: disable=R1(why this one is safe)
    # repro-lint: disable-next-line=R1(why this one is safe)
    x = hash(k)

The runtime half of the subsystem is `repro_torch.core.simclock.TracingEventLoop`
(trace digests + tie-order race detection); see docs/analysis.md.
"""
from repro_torch.analysis.lint import (Finding, SIM_PACKAGES,  # noqa: F401
                                 lint_file, lint_paths)
from repro_torch.analysis.crosscheck import crosscheck  # noqa: F401
