"""Device: the share, in %, of the ``RealExecutor.step`` spans in which no
kernel ran. Every kernel of the window runs inside those spans (the engine's
scheduling and sampling and the harness are host work, and each executor
step ends in a synchronisation), so the trace's busy time is the busy time
inside them."""


def read(win, name):
    if win.trace is None:
        return None
    span = sum(s.e1 - s.e0 for s in win.steps)
    if not span:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / span)
