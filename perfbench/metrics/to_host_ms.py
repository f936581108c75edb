"""Model step: the summed ``executor.to_host`` spans of a step, in ms, over
the steps that called the executor: waiting for the pass's kernels still
queued on the device, the logits' copy to pageable host memory and their
cast (the program's step spans). The wait makes it rise when
``executor.launch`` gets shorter; ``to_host_copy_ms`` is the copy alone."""
from perfbench import stepspans


def read(win, name):
    steps = [s for s in stepspans.spans(win) or ()
             if s.of("executor.step")]
    if not steps:
        return None
    return 1e3 * sum(s.total("executor.to_host") for s in steps) / len(steps)
