"""Engine layer: the mean ``engine.schedule`` span a step, in ms: the
scheduler's pass and the building of the executor's inputs (the program's
step spans; none where the window has none)."""
from perfbench import stepspans


def read(win, name):
    steps = stepspans.spans(win)
    if not steps:
        return None
    return 1e3 * sum(s.total("engine.schedule") for s in steps) / len(steps)
