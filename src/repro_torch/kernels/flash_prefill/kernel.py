"""ctypes wrapper of the hand-written CUDA flash prefill kernels
(``repro_torch/csrc/flash_prefill.cu``), which replace the Pallas TPU kernel
``repro/kernels/flash_prefill/kernel.py:flash_prefill``: bf16 runs on the
tensor cores (wgmma fed by TMA), f32 on the CUDA cores.

``flash_prefill.launches`` counts the kernel's launches. ``plan`` is the
host-side choice of tile, in plain Python so that it can be checked without a
card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 64     # the QPK heads of a run of positions stack into 64 rows
KEY_TILE = 64      # keys per K/V tile of the bf16 kernel
MAX_Q_PER_KV = TILE_ROWS
WGMMA_HEAD_DIMS = (64, 96, 128, 256)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the C entry receives; it launches the bf16 kernel on the grid
    (KV * B, q_tiles) and the f32 one on (q_tiles, KV, B)."""
    positions: int         # query positions per 64-row tile; the rows past
                           # positions * QPK are dead
    q_tiles: int           # query tiles per (batch, KV head)


@functools.lru_cache(maxsize=256)
def plan(b: int, t: int, h: int, kv: int, d: int, dtype) -> Plan:
    """The tiling for q (b, t, h, d) and k/v (b, t, kv, d).
    Raises ValueError for a shape or dtype no kernel takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_prefill kernel: unsupported dtype {dtype}")
    if b <= 0 or t <= 0 or kv <= 0 or h % kv or h // kv > MAX_Q_PER_KV:
        raise ValueError(f"flash_prefill kernel: bad heads or sizes b={b} "
                         f"t={t} h={h} kv={kv}")
    qpk = h // kv
    positions = TILE_ROWS // qpk
    q_tiles = -(-t // positions)
    if dtype == torch.bfloat16 and d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel: bf16 takes head_dim in "
                         f"{WGMMA_HEAD_DIMS}, not {d}")
    if not 0 < d <= 256:
        raise ValueError(f"flash_prefill kernel: head_dim {d} not in 1..256")
    return Plan(positions, q_tiles)


@functools.cache
def _entry():
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@build.counted
def flash_prefill(q, k, v, window: int = 0, out=None):
    """q: (B, T, H, D); k/v: (B, T, KV, D) -> (B, T, H, D). Any T; all
    tensors contiguous and 16-byte aligned on one CUDA device, one dtype:
    f32 (any D up to 256) or bf16 (D 64, 96, 128 or 256). With ``out``
    (q's shape and dtype, as q is laid out) the kernel writes there and
    returns it, in place of a new tensor."""
    b, t, h, d = q.shape
    dev = q.get_device()  # -1 on the CPU; ints keep the checks cheap
    if dev < 0 or k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_prefill kernel: q, k, v must be on one CUDA "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill kernel: unsupported dtypes "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    kvh = k.shape[2]
    if k.shape != (b, t, kvh, d) or v.shape != k.shape or window < 0:
        raise ValueError(f"flash_prefill kernel: bad shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"window {window}")
    p = plan(b, t, h, kvh, d, q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel: tensors must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_prefill kernel: tensors must be 16-byte "
                         "aligned")
    if out is None:
        out = torch.empty_like(q)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.get_device() != dev or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"flash_prefill kernel: out must be a contiguous, "
                         f"16-byte aligned {tuple(q.shape)} {q.dtype} tensor "
                         f"on q's device")
    lib, fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, t, h, kvh, d, window, d ** -0.5, _DTYPES[q.dtype],
             p.positions, p.q_tiles, build.current_stream(dev))
    build.check(lib, "flash_prefill", err)
    flash_prefill.launches += 1
    return out
