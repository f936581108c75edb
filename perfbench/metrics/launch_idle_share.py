"""Device: the share, in %, of the ``executor.launch`` spans (decode and
prefill) in which no kernel ran on the device: the device waiting while
the host issues a pass's kernels (the program's step spans against the
device trace)."""
from perfbench import harness, stepspans


def read(win, name):
    steps = stepspans.spans(win)
    if win.trace is None or not steps:
        return None
    launch = sorted((a, b) for s in steps for _, a, b, _ in
                    s.of("executor.launch"))
    span = sum(b - a for a, b in launch)
    if not span:
        return None
    return 100.0 * (1.0 - harness.busy_within(win.trace.intervals, launch)
                    / span)
