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
