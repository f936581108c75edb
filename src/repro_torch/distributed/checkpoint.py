"""Atomic, content-verified checkpoints of nested dicts of tensors, in the
JAX package's on-disk format (``repro/distributed/checkpoint.py``), so that
a checkpoint written by either package restores in the other:

  * one ``<dotted.leaf.name>.npy`` per leaf, gathered and unsharded, in a
    ``step_%010d`` directory;
  * atomic: the directory is written under a temporary name and renamed
    only once every leaf and the manifest are on disk, so a writer that dies
    midway never leaves a checkpoint that restore would pick up;
  * content-verified: ``manifest.json`` holds each leaf's shape, dtype and
    the SHA-256 of its file, checked before the leaf is handed back;
  * ``keep`` bounds how many checkpoints stay on disk;
  * elastic: a tree of DTensors is gathered leaf by leaf on every rank
    (``full_tensor`` is a collective) and written by rank 0 alone, the
    other ranks waiting at a barrier until the checkpoint is published;
    ``restore_checkpoint(..., shardings=)`` puts each leaf onto a mesh of
    any shape, so a checkpoint written on one mesh, or on none, restores
    onto another.

numpy has no bfloat16 of its own. A bf16 leaf is written as its 16-bit
patterns viewed as a 2-byte void, with "bfloat16" as its dtype in the
manifest; the JAX package's restore views that as ``ml_dtypes.bfloat16``,
and this one as ``torch.bfloat16``. Nothing here imports ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import require as require_device
from repro_torch.distributed import sharding as sh

_BF16 = "bfloat16"
_VOID2 = np.dtype("V2")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_array(leaf):
    """A leaf (tensor, array or number; not a DTensor) as a numpy array and
    the dtype name the manifest records for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_VOID2), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:                   # an ml_dtypes array
        return arr.view(_VOID2), _BF16
    return arr, str(arr.dtype)


def _to_tensor(arr, dtype: str, device):
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if str(arr.dtype) != dtype:
        raise IOError(f"leaf stored as {arr.dtype}, manifest says {dtype}")
    return torch.from_numpy(arr).to(device)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any,
                    keep: int = 3) -> Path:
    """Writes ``tree`` as checkpoint ``step``. A tree that holds DTensors
    must be saved by every rank of their process group at once, into a
    ``ckpt_dir`` that every rank shares: rank 0 writes it, and every rank
    reads it back on restore."""
    ckpt_dir = Path(ckpt_dir)
    sharded = any(isinstance(leaf, DTensor) for _, leaf in _leaf_paths(tree))
    writes = not sharded or dist.get_rank() == 0
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f".tmp_step_{step:010d}_{os.getpid()}"
    if writes:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

    manifest = {"step": int(step), "time": time.time(), "leaves": {}}
    for path, leaf in _leaf_paths(tree):
        if isinstance(leaf, DTensor):
            with torch.no_grad():
                leaf = leaf.full_tensor()          # every rank gathers
        if not writes:
            continue
        name = ".".join(path)
        arr, dtype = _to_array(leaf)
        fn = tmp / (name + ".npy")
        np.save(fn, arr, allow_pickle=False)
        digest = hashlib.sha256(fn.read_bytes()).hexdigest()
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": dtype, "sha256": digest,
        }
    if writes:
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                  # atomic publish
        _gc(ckpt_dir, keep)
    if sharded:
        dist.barrier()                     # published before any rank reads
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, step: Optional[int] = None,
                       device="cuda", shardings: Any = None,
                       verify: bool = True):
    """Returns (step, tree): the tree of tensors on ``device`` (the card
    unless the caller asks for the CPU), the latest step when ``step`` is
    None. With ``shardings`` (a tree of ``sharding.NamedSharding``, as
    ``param_shardings`` gives), each leaf is a DTensor on its mesh with
    those placements, its local shard on ``device`` (elastic restore):
    every rank reads the same files, checks the same hashes and cuts its
    own shard, so no collective runs."""
    device = require_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    tree: dict = {}
    for name, meta in manifest["leaves"].items():
        fn = d / (name + ".npy")
        if verify:
            digest = hashlib.sha256(fn.read_bytes()).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {fn}")
        arr = np.load(fn, allow_pickle=False)
        path = tuple(name.split("."))
        if shardings is None:
            leaf = _to_tensor(arr, meta["dtype"], device)
        else:
            leaf = sh.distribute(_to_tensor(arr, meta["dtype"], "cpu"),
                                 _get_path(shardings, path), device)
        _set_path(tree, path, leaf)
    return step, tree


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
