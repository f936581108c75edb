"""Model step: the device time, in ms, of the device-to-host copies
(``Memcpy DtoH`` in the device trace) a step that called the executor, the
steps ``to_host_ms`` counts: the logits' copy alone. ``to_host_ms`` also
holds the host's wait for the pass's kernels still queued on the card, so
it rises when the launch gets shorter; this one does not."""
from perfbench import harness, stepspans


def read(win, name):
    steps = [s for s in stepspans.spans(win) or ()
             if s.of("executor.step")]
    if win.trace is None or not steps:
        return None
    return 1e3 * harness.kernel_seconds(win.trace, ("Memcpy DtoH",)) \
        / len(steps)
