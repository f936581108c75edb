"""Public entry point for flash prefill, dispatched by device: a CPU tensor
takes the plain PyTorch version, a CUDA tensor the hand-written kernel, which
launches or raises. A meta tensor or a DTensor raises."""
from __future__ import annotations

from repro_torch.device import kernel_device
from repro_torch.kernels.flash_prefill import kernel
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref


def flash_prefill(q, k, v, window: int = 0):
    if kernel_device(q) == "cpu":
        return flash_prefill_ref(q, k, v, window)
    return kernel.flash_prefill(q, k, v, window)
