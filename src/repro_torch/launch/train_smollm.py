"""End-to-end training run: smollm-135m for a few hundred steps with the
WSD schedule and checkpoint/restart, the counterpart of the JAX package's
``examples/train_smollm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_smollm \
        [--steps 150] [--full] [--device cpu]

--full trains the real 135M configuration; by default the width shrinks
(d 192, vocab 8192, f32) and the 30-layer depth stays. Trains on the card
unless ``--device cpu`` is given; without a card it stops with an error.
"""
import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch import configs
from repro_torch.device import require
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import wsd_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_smollm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require(args.device)

    cfg = configs.get("smollm-135m")
    if not args.full:
        cfg = replace(cfg, d_model=192, num_heads=6, num_kv_heads=3,
                      head_dim=32, d_ff=512, vocab_size=8192,
                      param_dtype="float32")
    n = cfg.num_params()
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"({n / 1e6:.1f}M params) on {device}")

    tcfg = TrainerConfig(seq_len=128, global_batch=4, steps=args.steps,
                         ckpt_every=50, ckpt_dir=args.ckpt_dir,
                         peak_lr=6e-4, warmup_steps=20, log_every=10)
    schedule = wsd_schedule(tcfg.peak_lr, warmup_steps=20,
                            stable_steps=int(args.steps * 0.7),
                            decay_steps=int(args.steps * 0.2))
    tr = Trainer(cfg, tcfg, schedule=schedule, device=device)
    if tr.step_idx:
        print(f"resumed from checkpoint at step {tr.step_idx}")
    hist = tr.run()
    tr.save()
    first = hist[0]["loss"] if hist else float("nan")
    print(f"\nloss: {first:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{len(hist)} steps; tokens/step="
          f"{tcfg.seq_len * tcfg.global_batch}")
    return hist


if __name__ == "__main__":
    main()
