"""AdamW and learning-rate schedules on nested dicts of tensors: the
counterpart of ``repro/train/optimizer.py``, with its formulas (not
``torch.optim``).

AdamW clips by global norm, keeps f32 moments whatever the parameter's
dtype and a 0-d int32 step, and applies the update in f32 before casting
back to the parameter's dtype. Where the reference returns new trees (and
its trainer donates the old ones), ``update`` writes the parameters and the
state in place and returns the same dicts. Schedules map a step (a number
or a tensor) to an f32 tensor on the step's device, so a step on the card
never waits for the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


def leaves(tree):
    """A nested dict's leaves in sorted-key order, as ``jax.tree.leaves``
    orders a dict's."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    have its structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


# -- schedules ---------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, min_ratio: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (minicpm): linear warmup, long plateau, sharp
    exponential-style decay tail."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        in_decay = step - (warmup_steps + stable_steps)
        frac = torch.clamp(in_decay / max(decay_steps, 1), 0, 1)
        decay = peak_lr * (min_ratio ** frac)
        return torch.where(step < warmup_steps, warm,
                           torch.where(in_decay < 0,
                                       torch.full_like(step, peak_lr), decay))
    return lr


# -- AdamW ---------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        some = next(leaves(params))
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device),
        }

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """One step on ``params`` and ``opt_state``, both written in place.
        Returns (params, opt_state, {"grad_norm", "lr"})."""
        step = opt_state["step"].add_(1)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1 - self.b1 ** stepf
        bc2 = 1 - self.b2 ** stepf
        lr = self.schedule(step)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))

        tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    ).sum())
