"""Model step: ms of ``RealExecutor.step`` per thousand prompt tokens
computed, over the steps that computed a prefill (a step that also decoded
counts whole)."""


def read(win, name):
    steps = [s for s in win.steps if s.prefills]
    tokens = sum(sum(s.prefills) for s in steps)
    if not tokens:
        return None
    return 1e3 * sum(s.e1 - s.e0 for s in steps) / (tokens / 1e3)
