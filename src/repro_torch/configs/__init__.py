"""Architecture registry of the PyTorch port: the dense configurations it
serves so far. ``get(arch_id)`` resolves the ids used by ``--arch``."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs import (
    mistral_small_24b,
    phi3_mini_3_8b,
    qwen3_1_7b,
    smollm_135m,
)

CONFIGS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen3_1_7b.CONFIG,
        smollm_135m.CONFIG,
        phi3_mini_3_8b.CONFIG,
        mistral_small_24b.CONFIG,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
