"""Architecture registry of the PyTorch port: the configurations of the
families it serves (dense, vlm and moe on the paged path; ssm and hybrid
through the slot-state executor; audio through the model API).
``get(arch_id)`` resolves the ids used by ``--arch``."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs import (
    kimi_k2_1t_a32b,
    mamba2_780m,
    minicpm_2b,
    mistral_small_24b,
    phi3_mini_3_8b,
    pixtral_12b,
    qwen3_1_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    smollm_135m,
    whisper_small,
)

CONFIGS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen3_1_7b.CONFIG,
        smollm_135m.CONFIG,
        phi3_mini_3_8b.CONFIG,
        mistral_small_24b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        kimi_k2_1t_a32b.CONFIG,
        pixtral_12b.CONFIG,
        minicpm_2b.CONFIG,
        mamba2_780m.CONFIG,
        recurrentgemma_9b.CONFIG,
        whisper_small.CONFIG,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
