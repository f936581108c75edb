"""Engine layer: the mean ``engine.sample`` span a step, in ms: sampling
the step's decode rows and finished prompts from their logits on the host,
and emitting the tokens (the program's step spans)."""
from perfbench import stepspans


def read(win, name):
    steps = stepspans.spans(win)
    if not steps:
        return None
    return 1e3 * sum(s.total("engine.sample") for s in steps) / len(steps)
