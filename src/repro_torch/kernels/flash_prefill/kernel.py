"""ctypes wrapper of the hand-written CUDA flash prefill kernel
(``repro_torch/csrc/flash_prefill.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_prefill/kernel.py:flash_prefill``.

``flash_prefill.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_Q_PER_KV = 64  # the QPK heads of a position share one 64-row tile


@functools.cache
def _entry():
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_prefill(q, k, v, window: int = 0):
    """q: (B, T, H, D); k/v: (B, T, KV, D) -> (B, T, H, D). Any T; all
    tensors contiguous on one CUDA device, one dtype (f32 or bf16)."""
    b, t, h, d = q.shape
    if any(x.device != q.device or x.device.type != "cuda" for x in (k, v)) \
            or q.device.type != "cuda":
        raise ValueError("flash_prefill kernel: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill kernel: unsupported dtypes "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    kvh = k.shape[2]
    if (k.shape != (b, t, kvh, d) or v.shape != k.shape or h % kvh
            or h // kvh > MAX_Q_PER_KV or not 0 < d <= 256 or window < 0):
        raise ValueError(f"flash_prefill kernel: bad shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"window {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel: tensors must be contiguous")
    out = torch.empty_like(q)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, t, h, kvh, d, window, d ** -0.5, _DTYPES[q.dtype], stream)
    build.check(lib, "flash_prefill", err)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
