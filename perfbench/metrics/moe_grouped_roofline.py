"""Kernels: the grouped expert GEMM's share of its roofline, in %: the bound
of the window's calls over the device time of the kernel's two launches
(``grouped_bf16``, ``grouped_f32``) in the trace.

A call is one MoE layer of one model pass: each layer of a decode pass of
s sequences routes s x k rows, each layer of a computed prefill of t tokens
t x k. Its bound is the larger of its operations at 989 TFLOP/s (2 x 3 x d
x f a routed row: gate, up and down) and its bytes at 3.35 TB/s: the
weights of k experts, the fewest a call can read (a token's k experts are
distinct), and the routed rows in and out once, in bf16. A decode pass
reads far more than k experts (about 121 of 128 at the chat cell's batch),
which the traced run does not see, so the share understates decode; it
cannot pass 100 %, and it rises whenever the kernel gets faster at fixed
work."""
from perfbench import harness, yardstick

KERNELS = ("grouped_bf16", "grouped_f32")


def call_bytes_ops(rows: int, k: int, d: int, f: int,
                   dtype_bytes: int = yardstick.BF16) -> tuple[int, int]:
    """(bytes, operations) of one call over ``rows`` routed rows."""
    n_bytes = dtype_bytes * (k * 3 * d * f + 2 * rows * d)
    return n_bytes, 2 * 3 * d * f * rows


def call_s(rows: int, k: int, d: int, f: int) -> float:
    return yardstick.bound_s(*call_bytes_ops(rows, k, d, f),
                             yardstick.PEAK_BF16)


def window_bound_s(cfg: dict, steps) -> float:
    """The bound of every call the window's ``steps`` made."""
    k, d, f = (cfg["num_experts_per_tok"], cfg["hidden_size"],
               cfg["moe_intermediate_size"])
    tokens = [s.decode_seqs for s in steps if s.decode_seqs]
    tokens += [t for s in steps for t in s.prefills]
    return cfg["num_hidden_layers"] * sum(call_s(n * k, k, d, f)
                                          for n in tokens)


def read(win, name):
    if win.trace is None or win.config["family"] != "moe":
        return None
    device_s = harness.kernel_seconds(win.trace, KERNELS)
    bound = window_bound_s(win.config, win.steps)
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s
