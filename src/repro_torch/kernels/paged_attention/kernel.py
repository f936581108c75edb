"""ctypes wrapper of the hand-written CUDA paged decode kernels
(``repro_torch/csrc/paged_attention.cu``), which replace the Pallas TPU
kernel ``repro/kernels/paged_attention/kernel.py:paged_attention``.

``paged_attention.launches`` counts the wrapper's calls that launched: one
per call, though each call launches two kernels (the split pass and the
combine), so the main path counts one per layer per decode step. ``plan`` is
the host-side choice of split and scratch, in plain Python so that it can be
checked without a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q, pool) dtype pairs the kernel is built for: the main path's bf16 q on an
# f32 pool, and matching types.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}
SPAN_TOKENS = 256          # tokens of context per split (whole pages)
HEAD_DIMS = (32, 64, 96, 128)
MAX_Q_PER_KV = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the C entry receives; it launches the split kernel on the grid
    (splits, KV, S)."""
    span_pages: int        # pages per split
    splits: int            # splits per (sequence, KV head)
    # f32 scratch, one buffer: partial (max, sum) per (S, H, split), then the
    # partial accumulators (S, H, splits, D)
    scratch_numel: int


@functools.lru_cache(maxsize=64)
def plan(s: int, h: int, kv: int, d: int, bs: int, mb: int) -> Plan:
    """The split and scratch for q (s, h, d), a pool of kv heads in pages of
    bs tokens and block tables of mb pages. From the shapes alone: the
    context lengths, which live on the device, are never read. Raises
    ValueError for a shape the kernel does not take."""
    if s <= 0 or kv <= 0 or bs <= 0 or mb <= 0 or h % kv:
        raise ValueError(f"paged_attention kernel: bad sizes s={s} h={h} "
                         f"kv={kv} bs={bs} mb={mb}")
    if d not in HEAD_DIMS or h // kv > MAX_Q_PER_KV:
        raise ValueError(f"paged_attention kernel: takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_Q_PER_KV} query heads "
                         f"per KV head, not D={d}, QPK={h // kv}")
    span_pages = max(1, SPAN_TOKENS // bs)
    splits = -(-mb // span_pages)
    return Plan(span_pages, splits, s * h * splits * (d + 2))


@functools.cache
def _entry():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attention(q, pool_k, pool_v, block_tables, context_lens):
    """q: (S, H, D); pool_k/v: (NB, BS, KV, D); block_tables: (S, MB) int32;
    context_lens: (S,) int32. Returns (S, H, D) in q's dtype. All tensors
    contiguous on one CUDA device; (q, pool) f32/f32, bf16/bf16 or bf16/f32;
    D 32, 64, 96 or 128; at most 16 query heads per KV head; the pools 16-byte
    aligned. Block ids of live pages must lie in [0, NB). Reads nothing back
    from the device, so the call can be captured in a CUDA graph."""
    s, h, d = q.shape
    _, bs, kv, dk = pool_k.shape
    mb = block_tables.shape[-1]
    tensors = (q, pool_k, pool_v, block_tables, context_lens)
    dev = q.get_device()  # -1 on the CPU; ints keep the checks cheap
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError("paged_attention kernel: all tensors must be on one "
                         "CUDA device")
    if (q.dtype, pool_k.dtype) not in _PAIRS or pool_v.dtype != pool_k.dtype:
        raise ValueError(f"paged_attention kernel: unsupported dtypes "
                         f"{q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention kernel: block_tables and "
                         "context_lens must be int32")
    if (pool_v.shape != pool_k.shape or dk != d
            or block_tables.shape != (s, mb) or context_lens.shape != (s,)):
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
    p = plan(s, h, kv, d, bs, mb)
    out = torch.empty_like(q)
    scratch = torch.empty(p.scratch_numel, dtype=torch.float32,
                          device=q.device)
    lib, fn = _entry()
    err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
             scratch.data_ptr(),
             s, h, kv, d, bs, mb, p.span_pages, p.splits, d ** -0.5,
             _DTYPES[q.dtype], _DTYPES[pool_k.dtype], build.current_stream(dev))
    build.check(lib, "paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
