"""Public entry point for paged decode attention, dispatched by device: a
CPU tensor takes the plain PyTorch version, a CUDA tensor the hand-written
kernel, which launches or raises."""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, pool_k, pool_v, block_tables, context_lens):
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, block_tables,
                                   context_lens)
    return kernel.paged_attention(q, pool_k, pool_v, block_tables,
                                  context_lens)
