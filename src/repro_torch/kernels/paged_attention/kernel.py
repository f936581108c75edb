"""ctypes wrapper of the hand-written CUDA paged decode kernel
(``repro_torch/csrc/paged_attention.cu``), which replaces the Pallas TPU
kernel ``repro/kernels/paged_attention/kernel.py:paged_attention``.

``paged_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q, pool) dtype pairs the kernel is built for: the main path's bf16 q on an
# f32 pool, and matching types.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}


@functools.cache
def _entry():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attention(q, pool_k, pool_v, block_tables, context_lens):
    """q: (S, H, D); pool_k/v: (NB, BS, KV, D); block_tables: (S, MB) int32;
    context_lens: (S,) int32. Returns (S, H, D) in q's dtype. All tensors
    contiguous on one CUDA device; (q, pool) f32/f32, bf16/bf16 or bf16/f32;
    D a multiple of 16 bytes' worth of pool elements, the pools 16-byte
    aligned. Block ids of live pages must lie in [0, NB)."""
    s, h, d = q.shape
    _, bs, kv, dk = pool_k.shape
    mb = block_tables.shape[-1]
    tensors = (q, pool_k, pool_v, block_tables, context_lens)
    if any(t.device != q.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("paged_attention kernel: all tensors must be on one "
                         "CUDA device")
    if (q.dtype, pool_k.dtype) not in _PAIRS or pool_v.dtype != pool_k.dtype:
        raise ValueError(f"paged_attention kernel: unsupported dtypes "
                         f"{q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention kernel: block_tables and "
                         "context_lens must be int32")
    if (pool_v.shape != pool_k.shape or dk != d or h % kv
            or block_tables.shape != (s, mb) or context_lens.shape != (s,)
            or not 0 < d <= 256):
        raise ValueError(
            f"paged_attention kernel: bad shapes q {tuple(q.shape)}, pool "
            f"{tuple(pool_k.shape)}, tables {tuple(block_tables.shape)}, "
            f"lens {tuple(context_lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel: tensors must be contiguous")
    if (d * pool_k.element_size() % 16 or pool_k.data_ptr() % 16
            or pool_v.data_ptr() % 16):
        raise ValueError("paged_attention kernel: D must fill whole 16-byte "
                         "loads and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
             s, h, kv, d, bs, mb, d ** -0.5, _DTYPES[q.dtype],
             _DTYPES[pool_k.dtype], stream)
    build.check(lib, "paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
