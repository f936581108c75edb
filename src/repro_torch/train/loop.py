"""Training loop with checkpoint/restart: the counterpart of
``repro/train/loop.py``.

The data pipeline is a pure function of (seed, step), so a restart replays
exactly; checkpoints are atomic and written every ``ckpt_every`` steps, and
a new ``Trainer`` resumes from the latest one on construction. Steps run
eagerly. Without a mesh the state lives on one device. With one (a
``DeviceMesh`` over a real process group, one process per rank) every rank
runs this same loop: the state is sharded as the reference shards it
(params and AdamW's moments under ``TRAIN_RULES``, the step counter
replicated), each batch over the data axes, and a checkpoint written on one
mesh, or on none, restores onto another.

As in the reference, the trainer feeds only tokens and labels, so the vlm
and audio families, whose loss needs patch embeddings or frames, cannot be
trained through it: it refuses them up front and says so (``api.loss_fn``
takes both).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import ModelConfig
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.device import require as require_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as sh
from repro_torch.models import api
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
    the CPU. ``mesh``, a ``DeviceMesh`` over a real process group whose
    device type is ``device``'s, shards the state over it; every rank
    builds its own ``Trainer`` with the same arguments."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 schedule: Optional[Callable] = None, params=None,
                 device="cuda", mesh=None):
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
        self.mesh = mesh
        if mesh is not None:
            if sh.is_fake(mesh.get_group(0)):
                raise RuntimeError(
                    "the mesh is over a fake process group, whose collectives "
                    "compute nothing; train on a gloo or NCCL one")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                                 f"{self.device}")
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
        self.state_shardings = None
        if mesh is not None:
            psh = sh.param_shardings(mesh, self.state["params"],
                                     api.param_axes(cfg), sh.TRAIN_RULES)
            self.state_shardings = {
                "params": psh,
                "opt": {"m": psh, "v": psh, "step": sh.replicated(mesh)},
            }
            self.state = sh.distribute(self.state, self.state_shardings)

        # ---- resume-from-latest (fault tolerance) ----
        latest = ckpt.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            self.step_idx, tree = ckpt.restore_checkpoint(
                tcfg.ckpt_dir, latest, device=self.device,
                shardings=self.state_shardings)
            self.state = tree_map(lambda cur, new: new.to(cur.dtype),
                                  self.state, tree)

        self._step = make_train_step(cfg, self.opt)

    @property
    def is_logger(self) -> bool:
        """Whether this process prints: rank 0 of a mesh, or the only one."""
        return self.mesh is None or dist.get_rank() == 0

    def _batch(self, step: int):
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.pipeline.batch(step).items()}
        if self.mesh is None:
            return batch
        return sh.distribute(batch, {
            k: sh.batch_sharding(self.mesh, v.shape)
            for k, v in batch.items()})

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> list[dict]:
        target = self.tcfg.steps if steps is None else self.step_idx + steps
        with self._sharded():
            while self.step_idx < target:
                batch = self._batch(self.step_idx)
                t0 = time.time()
                self.state, metrics = self._step(self.state, batch)
                metrics = {k: float(sh.whole(v)) for k, v in metrics.items()}
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                metrics["step"] = self.step_idx
                metrics["wall_s"] = time.time() - t0
                self.history.append(metrics)
                self.step_idx += 1
                if self.step_idx % self.tcfg.log_every == 0 \
                        and self.is_logger:
                    print(f"step {self.step_idx:5d} "
                          f"loss {metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f} "
                          f"lr {metrics['lr']:.2e}")
                if self.step_idx % self.tcfg.ckpt_every == 0:
                    self.save()
        return self.history

    @contextlib.contextmanager
    def _sharded(self):
        """With a mesh: the activation rules installed for the block only,
        and plain tensors made inside the model (masks, positions) taken as
        replicated."""
        if self.mesh is None:
            yield
            return
        sh.install_activation_rules(self.mesh)
        try:
            with implicit_replication():
                yield
        finally:
            sh.clear_activation_rules()

    def save(self):
        ckpt.save_checkpoint(self.tcfg.ckpt_dir, self.step_idx, self.state)

    def loss_curve(self):
        return [m["loss"] for m in self.history]
