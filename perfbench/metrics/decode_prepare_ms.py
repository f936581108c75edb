"""Model step: the mean decode ``executor.prepare`` span, in ms, of the
steps that decoded and computed no prefill: the block tables built on the
host and the step's inputs copied to the device (the program's step
spans)."""
from perfbench import stepspans


def read(win, name):
    steps = [s for s in stepspans.spans(win) or () if s.decode_only]
    if not steps:
        return None
    return 1e3 * sum(s.total("executor.prepare", "decode")
                     for s in steps) / len(steps)
