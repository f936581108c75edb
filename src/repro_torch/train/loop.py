"""Training loop with checkpoint/restart: the counterpart of
``repro/train/loop.py`` on one card.

The data pipeline is a pure function of (seed, step), so a restart replays
exactly; checkpoints are atomic and written every ``ckpt_every`` steps, and
a new ``Trainer`` resumes from the latest one on construction. There is no
mesh: the state lives on one device, and steps run eagerly.

As in the reference, the trainer feeds only tokens and labels, so the vlm
and audio families, whose loss needs patch embeddings or frames, cannot be
trained through it: it refuses them up front and says so (``api.loss_fn``
takes both).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.device import require as require_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW, cosine_schedule, tree_map
from repro_torch.train.step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    seq_len: int = 512
    global_batch: int = 8
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    seed: int = 0
    log_every: int = 10


class Trainer:
    """``params``, when given, is the initial parameter tree (copied to
    ``device``); otherwise the weights are drawn from a generator seeded
    with ``tcfg.seed``. ``device`` is the card unless the caller asks for
    the CPU."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 schedule: Optional[Callable] = None, params=None,
                 device="cuda"):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"{cfg.name}: the trainer feeds tokens and labels only, and a "
                f"{cfg.family} loss also needs "
                f"{'patch_embeds' if cfg.family == 'vlm' else 'frames'} (the "
                f"reference's trainer fails on it the same way); call "
                f"api.loss_fn with them instead")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = require_device(device)
        self.opt = AdamW(schedule or cosine_schedule(
            tcfg.peak_lr, tcfg.warmup_steps, tcfg.steps))
        self.pipeline = TokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.step_idx = 0
        self.history: list[dict] = []

        self.state = init_train_state(
            cfg, self.opt, torch.Generator(self.device).manual_seed(tcfg.seed),
            self.device, params)

        # ---- resume-from-latest (fault tolerance) ----
        latest = ckpt.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            self.step_idx, tree = ckpt.restore_checkpoint(
                tcfg.ckpt_dir, latest, device=self.device)
            self.state = tree_map(lambda cur, new: new.to(cur.dtype),
                                  self.state, tree)

        self._step = make_train_step(cfg, self.opt)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> list[dict]:
        target = self.tcfg.steps if steps is None else self.step_idx + steps
        while self.step_idx < target:
            batch = self.pipeline.batch(self.step_idx)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            t0 = time.time()
            self.state, metrics = self._step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            metrics["step"] = self.step_idx
            metrics["wall_s"] = time.time() - t0
            self.history.append(metrics)
            self.step_idx += 1
            if self.step_idx % self.tcfg.log_every == 0:
                print(f"step {self.step_idx:5d} "
                      f"loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} "
                      f"lr {metrics['lr']:.2e}")
            if self.step_idx % self.tcfg.ckpt_every == 0:
                self.save()
        return self.history

    def save(self):
        ckpt.save_checkpoint(self.tcfg.ckpt_dir, self.step_idx, self.state)

    def loss_curve(self):
        return [m["loss"] for m in self.history]
