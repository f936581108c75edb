"""Training launcher of the PyTorch port: the counterpart of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 [--reduced] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --devices 4 --data 2 --model 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --data 2 --model 2

Trains on the card unless ``--device cpu`` is given; without a card it
stops with an error. As in the reference, a (data, model) mesh is built
only when ``data * model > 1`` or with ``--production-mesh``, and every
rank is a process of its own:
  * ``--devices N`` (CPU testing, the counterpart of the reference's N
    forced host devices) spawns N processes, each a gloo rank on the CPU;
  * without it, each process is one rank of the group torchrun started:
    NCCL on ``cuda:LOCAL_RANK``, one rank per card (gloo with ``--device
    cpu``);
  * ``--production-mesh`` is the reference's (16, 16) mesh over a real
    group of 256 ranks.
The mesh must have exactly the ranks there are, else the launcher raises;
it never trains over a fake process group. A checkpoint every 50 steps and
one at the end go to ``--ckpt-dir``, and a rerun resumes from the latest,
on a mesh of any shape.
"""
import argparse
import json
import math
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.device import require
from repro_torch.launch.mesh import (free_port, init_process_group,
                                     make_mesh, production_layout)
from repro_torch.train.loop import Trainer, TrainerConfig


def _mesh_layout(args):
    """(shape, axis names) of the run's mesh, None for no mesh."""
    if args.production_mesh:
        return production_layout()
    if args.data * args.model > 1:
        return (args.data, args.model), ("data", "model")
    return None


def _train(args, device, layout):
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_mesh(*layout) if layout else None
    tcfg = TrainerConfig(seq_len=args.seq_len,
                         global_batch=args.global_batch, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, ckpt_every=50)
    tr = Trainer(cfg, tcfg, device=device, mesh=mesh)
    if tr.step_idx and tr.is_logger:
        print(f"resuming from step {tr.step_idx}")
    hist = tr.run()
    tr.save()
    if tr.is_logger:
        print(f"done: step {tr.step_idx}, loss {hist[-1]['loss']:.4f}, "
              f"gnorm {hist[-1]['grad_norm']:.6f}" if hist else
              "no steps run")
    return hist


def _cpu_rank(rank, args, layout, port, out):
    """One of ``--devices``' processes: a gloo rank on the CPU."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    init_process_group("cpu", rank=rank, world_size=args.devices,
                       init_method=f"tcp://localhost:{port}")
    try:
        hist = _train(args, torch.device("cpu"), layout)
        if rank == 0:
            Path(out).write_text(json.dumps(hist))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.CONFIGS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU (testing); "
                         "data * model must equal it")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh over a real process "
                         "group of 256 ranks")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; --devices is the CPU")
    args = ap.parse_args(argv)

    layout = _mesh_layout(args)
    ranks = math.prod(layout[0]) if layout else 1
    if args.devices:
        if args.device not in (None, "cpu"):
            raise ValueError("--devices spawns gloo ranks on the CPU; it "
                             f"cannot train on {args.device}")
        if ranks != args.devices:
            raise RuntimeError(f"the mesh has {ranks} ranks and --devices "
                               f"is {args.devices}")
        if layout is None:
            return _train(args, require("cpu"), None)
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as d:
            out = Path(d) / "history.json"
            mp.spawn(_cpu_rank, args=(args, layout, free_port(), str(out)),
                     nprocs=args.devices)
            return json.loads(out.read_text())

    device = require(args.device or "cuda")
    if layout is None:
        return _train(args, device, None)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != ranks:
        raise RuntimeError(
            f"a {' x '.join(map(str, layout[0]))} mesh needs {ranks} ranks, "
            f"and WORLD_SIZE is {world}: run one process per rank under "
            f"torchrun (--nproc-per-node), or on the CPU with --devices "
            f"{ranks}")
    device = init_process_group(device)
    try:
        return _train(args, device, layout)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
