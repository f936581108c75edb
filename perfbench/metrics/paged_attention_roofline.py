"""Kernels: the paged decode attention's share of its roofline, in %: the
byte bound of the window's calls (one a layer a decode step, each input
byte read once at the f32 pool and the calls' contexts) over the device
time of ``paged_split`` and ``paged_combine`` in the trace."""
from perfbench import harness, yardstick


def read(win, name):
    if win.trace is None:
        return None
    device_s = harness.kernel_seconds(win.trace, harness.PAGED_KERNELS)
    cfg = win.config
    bound = cfg["num_hidden_layers"] * sum(
        yardstick.paged_call_s(s.decode_seqs, s.decode_ctx, s.decode_pages,
                               cfg["num_attention_heads"],
                               cfg["num_key_value_heads"], cfg["head_dim"])
        for s in win.steps if s.decode_seqs)
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s
