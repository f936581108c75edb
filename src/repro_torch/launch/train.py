"""Training launcher of the PyTorch port: the counterpart of
``repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 [--reduced] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card it
stops with an error. The reference's ``--devices``, ``--data``, ``--model``
and ``--production-mesh`` build a JAX mesh and have no one-device
counterpart. A checkpoint every 50 steps and one at the end go to
``--ckpt-dir``, and a rerun resumes from the latest.
"""
import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.device import require
from repro_torch.train.loop import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.CONFIGS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = require(args.device)

    tcfg = TrainerConfig(seq_len=args.seq_len,
                         global_batch=args.global_batch, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, ckpt_every=50)
    tr = Trainer(cfg, tcfg, device=device)
    if tr.step_idx:
        print(f"resuming from step {tr.step_idx}")
    hist = tr.run()
    tr.save()
    print(f"done: step {tr.step_idx}, loss {hist[-1]['loss']:.4f}"
          if hist else "no steps run")
    return hist


if __name__ == "__main__":
    main()
