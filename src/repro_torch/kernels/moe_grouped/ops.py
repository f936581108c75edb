"""Public entry point for the grouped expert feed-forward, dispatched by
device: a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel, which launches or raises. A meta tensor or a DTensor
raises."""
from __future__ import annotations

from repro_torch.device import kernel_device
from repro_torch.kernels.moe_grouped import kernel
from repro_torch.kernels.moe_grouped.ref import moe_grouped_ref


def moe_grouped(x, offsets, w_gate, w_up, w_down, out=None):
    if kernel_device(x) == "cpu":
        return moe_grouped_ref(x, offsets, w_gate, w_up, w_down, out)
    return kernel.moe_grouped(x, offsets, w_gate, w_up, w_down, out)
