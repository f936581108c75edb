"""Engine layer: the mean host time a step spends in ``LLMEngine.step``
outside ``RealExecutor.step`` (scheduling, sampling, emitting), in ms."""


def read(win, name):
    steps = win.steps
    if not steps:
        return None
    return 1e3 * sum((s.t1 - s.t0) - (s.e1 - s.e0) for s in steps) / len(steps)
