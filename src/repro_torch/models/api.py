"""Model API of the PyTorch port: the serving entry points of
``repro/models/api.py`` for every family (dense, vlm, moe, ssm, hybrid,
audio).

  init_params(cfg, generator, device)         -> params
  prefill_fn(params, cfg, batch)              -> (logits, cache)
  decode_fn(params, cfg, tokens, cache, pos)  -> (logits, cache)

Parameters carry no logical sharding axes: the port runs on one card. Every
function builds on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import griffin, mamba2, moe, transformer, whisper

_MODULES = {"dense": transformer, "vlm": transformer, "moe": moe,
            "hybrid": griffin, "ssm": mamba2, "audio": whisper}


def module_for(cfg: ModelConfig):
    return _MODULES[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    """Random weights on ``device``, from ``generator`` (by default one on
    the same device, seeded 0)."""
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return module_for(cfg).init(cfg, generator, device)


def prefill_fn(params, cfg: ModelConfig, batch, attention=None):
    """batch: {"tokens": (B, T)}, and "patch_embeds" for a vlm, "frames" for
    audio. ``attention`` replaces the flash-prefill op of the families that
    have attention (mamba2 has none)."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        return whisper.prefill(params, cfg, tokens, batch["frames"],
                               attention)
    if cfg.family == "vlm":
        return transformer.prefill(params, cfg, tokens, attention,
                                   patch_embeds=batch["patch_embeds"])
    if cfg.family == "ssm":
        return mamba2.prefill(params, cfg, tokens)
    return module_for(cfg).prefill(params, cfg, tokens, attention)


def decode_fn(params, cfg: ModelConfig, tokens, cache, pos):
    return module_for(cfg).decode_step(params, cfg, tokens, cache, pos)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype, device)


def pad_cache(cfg: ModelConfig, cache, max_len: int):
    """Grow a prefill-sized dense KV cache (L, B, T, KV, D) to max_len. The
    state caches (ssm, hybrid) are fixed-size already and come back as they
    are; cross-attention caches ("ck", "cv") never grow."""
    if cfg.family in ("ssm", "hybrid"):
        return cache

    def pad(x, key):
        if key in ("ck", "cv"):
            return x
        t = x.shape[2]
        if t >= max_len:
            return x[:, :, :max_len]
        return F.pad(x, (0, 0, 0, 0, 0, max_len - t))

    return {k: pad(v, k) for k, v in cache.items()}
