"""Bridge between the JAX package's parameter trees and the port's.

A JAX tree, as numpy arrays with the same nested keys and the stacked leading
layer axis, becomes the port's tree of tensors with identical keys, shapes
and dtypes, and back. bfloat16 arrays travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import require as require_device


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _to_array(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy has no bfloat16 of its own
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of tensors on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = require_device(device)
    return {k: from_numpy(v, device) if isinstance(v, dict)
            else _to_tensor(v, device) for k, v in tree.items()}


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict) else _to_array(v)
            for k, v in tree.items()}
