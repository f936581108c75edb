"""Model step: the mean ``RealExecutor.step`` span, in ms, of the steps that
decoded and computed no prefill."""


def read(win, name):
    spans = [s.e1 - s.e0 for s in win.steps if s.decode_seqs and not s.prefills]
    return 1e3 * sum(spans) / len(spans) if spans else None
