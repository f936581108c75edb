"""Where the port builds its tensors: on the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def require(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises RuntimeError for a CUDA
    device when none is available, so that what a caller meant for the card
    never lands on the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to build on "
                           "the CPU")
    return device


def kernel_device(t: torch.Tensor) -> str:
    """The device type a kernel's entry point dispatches on: "cpu" takes
    the plain version, anything else the hand-written kernel. A meta tensor
    or a DTensor (the dry run's) raises: neither holds data a kernel could
    read, and neither may pass to the plain version unnoticed. The dry run
    passes the plain attention itself."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) or t.device.type == "meta":
        raise TypeError(f"a {type(t).__name__} on {t.device} reached a "
                        "kernel's entry point: pass the plain version "
                        "explicitly")
    return t.device.type
