"""Whole step: model FLOPs over the time of ``RealExecutor.step`` spans at
the bf16 peak (989 TFLOP/s), in %. The steps counted follow the name's
suffix: one with ``decode`` counts the steps that computed no prefill, one
with ``prefill`` those that computed one, any other every step."""
from perfbench import yardstick


def read(win, name):
    kind = name.split(".", 1)[-1]
    steps = win.steps
    if "decode" in kind:
        steps = [s for s in steps if not s.prefills]
    elif "prefill" in kind:
        steps = [s for s in steps if s.prefills]
    span = sum(s.e1 - s.e0 for s in steps)
    if not span:
        return None
    flops = sum(yardstick.step_flops(win.config, s.decode_ctx, s.decode_seqs,
                                     s.prefills) for s in steps)
    return 100.0 * flops / (span * yardstick.PEAK_BF16)
