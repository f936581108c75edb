"""Step functions: the counterpart of ``repro/train/step.py``.

make_train_step : (state, batch) -> (state, metrics), state = params + opt
make_prefill_step / make_decode_step : the two serving entry points.

Steps run eagerly (there is no ``jax.jit``); the train step's gradient is
``torch.autograd.grad`` of ``api.loss_fn`` and its update writes the state
in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import api
from repro_torch.train.optimizer import AdamW, leaves, tree_map


def _unflatten(tree, flat):
    """``flat`` (in ``leaves`` order) back into ``tree``'s structure."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return build(tree)


def make_train_step(cfg: ModelConfig, opt: AdamW) -> Callable:
    def train_step(state, batch):
        params = state["params"]
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
        total, metrics = api.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(total, flat)
        _, _, opt_metrics = opt.update(_unflatten(params, grads), state["opt"],
                                       params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, attention=None) -> Callable:
    """``attention`` replaces the flash-prefill op (``api.prefill_fn``)."""
    def prefill_step(params, batch):
        return api.prefill_fn(params, cfg, batch, attention)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, tokens, cache, pos):
        return api.decode_fn(params, cfg, tokens, cache, pos)

    return decode_step


def init_train_state(cfg: ModelConfig, opt: AdamW,
                     generator: torch.Generator | None = None,
                     device="cuda", params=None, abstract: bool = False):
    """{"params", "opt": {"m", "v", "step"}}: a copy of ``params`` on
    ``device`` when given, else random weights from ``generator`` there (the
    card unless the caller asks for the CPU). With ``abstract`` every leaf
    is a meta tensor (params in their dtype, f32 moments, a 0-d int32 step)
    and nothing is drawn."""
    if abstract:
        params = api.init_params(cfg, abstract=True)
        return {"params": params, "opt": opt.init(params)}
    device = require_device(device)
    if params is None:
        params = api.init_params(cfg, generator, device)
    else:
        params = tree_map(lambda p: p.detach().to(device, copy=True), params)
    return {"params": params, "opt": opt.init(params)}
