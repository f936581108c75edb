"""ctypes wrapper of the hand-written CUDA grouped expert GEMM
(``repro_torch/csrc/moe_grouped.cu``), the MoE feed-forward when serving. It
replaces no TPU kernel: the JAX package runs its experts as batched products
over a capacity buffer, which drops rows (``repro/models/moe.py``).

``moe_grouped.launches`` counts the wrapper's calls that launched: one per
call, though each call launches two kernels (gate and up with SiLU, then
down), so the main path counts one per MoE layer per model pass (a graph
replay of a decode adds its layers' calls: ``paged_model.PagedDecoder``).

``counters`` holds, per CUDA device index, the int64 accumulator the kernel
adds to on every call, with no synchronisation: calls, routed rows, experts
with at least one row, and block-padding rows (``COUNTERS``). A CUDA graph
that captured a call keeps adding to the accumulator it saw, so once made
it stays in place. Nothing in the program reads it; ``tools/moe_routing.py``
reads it once after a window, split by phase with copies taken on the
device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_M = 64        # rows of a tile
BLOCK_N = 64        # output columns of a tile
MAX_EXPERTS = 1024
COUNTERS = ("calls", "routed_rows", "experts_touched", "padding_rows")
counters: dict[int, torch.Tensor] = {}


def row_tiles(rows: int, experts: int) -> int:
    """The grid's row tiles for ``rows`` routed rows over ``experts``: a
    bound from the host's sizes alone, since each expert adds at most one
    partial tile. The kernel's blocks past the last real tile exit."""
    return -(-rows // BLOCK_M) + experts


def counter(device: int) -> torch.Tensor:
    """The accumulator the kernel adds to on ``device``, made at first
    use."""
    c = counters.get(device)
    if c is None:
        c = counters[device] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                           device=f"cuda:{device}")
    return c


@functools.cache
def _entry():
    lib = build.load("moe_grouped")
    fn = lib.moe_grouped_ffn
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@build.counted
def moe_grouped(x, offsets, w_gate, w_up, w_down, out=None):
    """x: (R, d) routed rows sorted by expert; offsets: (E + 1,) int32, on
    the device, expert e's rows at offsets[e] .. offsets[e + 1] - 1 (the
    last is R); w_gate, w_up: (E, d, f); w_down: (E, f, d). Returns (R, d)
    in x's dtype: silu(x @ w_gate[e]) * (x @ w_up[e]) @ w_down[e] for each
    row of expert e, accumulated in f32, written into ``out`` if given
    (x's shape, dtype and device; x itself may be given: the down launch
    writes it only after the gate-and-up launch, before it on the stream,
    has read x). All tensors contiguous on one CUDA device, f32 or bf16
    alike, 16-byte aligned; d and f multiples of 64; at most 1024 experts.
    Reads nothing back from the device, so the call can be captured in a
    CUDA graph."""
    r, d = x.shape
    e, dk, f = w_gate.shape
    if out is None:
        out = torch.empty_like(x)
    tensors = (x, offsets, w_gate, w_up, w_down, out)
    dev = x.get_device()  # -1 on the CPU
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError("moe_grouped kernel: all tensors must be on one "
                         "CUDA device")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype
                                     for w in (w_gate, w_up, w_down, out)):
        raise ValueError(f"moe_grouped kernel: x, the weights and out must "
                         f"be f32 or bf16 alike, not {x.dtype}, "
                         f"{w_gate.dtype}, {w_up.dtype}, {w_down.dtype}, "
                         f"{out.dtype}")
    if offsets.dtype != torch.int32:
        raise ValueError("moe_grouped kernel: offsets must be int32")
    if (dk != d or w_up.shape != w_gate.shape or w_down.shape != (e, f, d)
            or offsets.shape != (e + 1,) or out.shape != x.shape):
        raise ValueError(
            f"moe_grouped kernel: bad shapes x {tuple(x.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)}, offsets {tuple(offsets.shape)}, out "
            f"{tuple(out.shape)}")
    if r < 1 or d % BLOCK_N or f % BLOCK_N or not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_grouped kernel: takes d and f in multiples of "
                         f"{BLOCK_N}, 1 to {MAX_EXPERTS} experts and at "
                         f"least one row, not d={d}, f={f}, E={e}, R={r}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_grouped kernel: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down, out)):
        raise ValueError("moe_grouped kernel: x, the weights and out must be "
                         "16-byte aligned")
    h = torch.empty(r, f, dtype=x.dtype, device=x.device)
    lib, fn = _entry()
    err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
             w_down.data_ptr(), offsets.data_ptr(), h.data_ptr(),
             out.data_ptr(), counter(dev).data_ptr(), r, e, d, f,
             row_tiles(r, e), _DTYPES[x.dtype], build.current_stream(dev))
    build.check(lib, "moe_grouped", err)
    moe_grouped.launches += 1
    return out
