"""Model step: the mean decode ``executor.launch`` span, in ms, of the
steps that decoded and computed no prefill: the host issuing the decode
pass's kernels, up to the last (the program's step spans)."""
from perfbench import stepspans


def read(win, name):
    steps = [s for s in stepspans.spans(win) or () if s.decode_only]
    if not steps:
        return None
    return 1e3 * sum(s.total("executor.launch", "decode")
                     for s in steps) / len(steps)
