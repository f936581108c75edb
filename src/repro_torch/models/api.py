"""Model API of the PyTorch port: the serving entry points of
``repro/models/api.py`` for the dense family.

  init_params(cfg, generator, device)         -> params
  prefill_fn(params, cfg, batch)              -> (logits, cache)
  decode_fn(params, cfg, tokens, cache, pos)  -> (logits, cache)

Parameters carry no logical sharding axes: the port runs on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import transformer

_MODULES = {"dense": transformer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return _MODULES[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cpu"):
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return module_for(cfg).init(cfg, generator, device)


def prefill_fn(params, cfg: ModelConfig, batch, attention=None):
    return module_for(cfg).prefill(params, cfg, batch["tokens"], attention)


def decode_fn(params, cfg: ModelConfig, tokens, cache, pos):
    return module_for(cfg).decode_step(params, cfg, tokens, cache, pos)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype, device)


def pad_cache(cfg: ModelConfig, cache, max_len: int):
    """Grow a prefill-sized dense KV cache (L, B, T, KV, D) to max_len."""
    module_for(cfg)

    def pad(x):
        t = x.shape[2]
        if t >= max_len:
            return x[:, :, :max_len]
        return F.pad(x, (0, 0, 0, 0, 0, max_len - t))

    return {k: pad(v) for k, v in cache.items()}
