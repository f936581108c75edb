"""Plain PyTorch grouped expert feed-forward: the arithmetic of the CUDA
kernel (``repro_torch/csrc/moe_grouped.cu``), one expert at a time.

Layouts:
  x        : (R, d)      the routed rows, sorted by expert
  offsets  : (E + 1,)    int32; expert e's rows are offsets[e] .. offsets[e+1]-1
  w_gate/up: (E, d, f)
  w_down   : (E, f, d)

Each row's SwiGLU is computed in f32 and ``h`` rounded to x's dtype once, as
the kernel rounds it; the output is accumulated in f32 and rounded once,
into ``out`` if given (x itself may be: each expert's rows are read before
they are written). ``out`` is here so that ``ops.moe_grouped`` has one
signature on both devices: only the card's serving path passes it (the
CPU's serving takes ``moe_block``'s (E, n, d) buffer instead).
Reads the offsets back to the host: the plain version is for the CPU and for
checks, never for the card's main path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_grouped_ref(x, offsets, w_gate, w_up, w_down, out=None):
    if out is None:
        out = torch.empty_like(x)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        rows = x[lo:hi].float()
        h = (F.silu(rows @ w_gate[e].float())
             * (rows @ w_up[e].float())).to(x.dtype)
        out[lo:hi] = (h.float() @ w_down[e].float()).to(x.dtype)
    return out
