"""Kernels: the flash prefill's share of its roofline, in %: the bound of
the window's calls (one a layer a prefill computed, causal, bf16, the
larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s) over the
device time of ``flash_prefill`` in the trace."""
from perfbench import harness, yardstick


def read(win, name):
    if win.trace is None:
        return None
    device_s = harness.kernel_seconds(win.trace, harness.FLASH_KERNELS)
    cfg = win.config
    bound = cfg["num_hidden_layers"] * sum(
        yardstick.flash_call_s(t, cfg["num_attention_heads"],
                               cfg["num_key_value_heads"], cfg["head_dim"])
        for s in win.steps for t in s.prefills)
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s
