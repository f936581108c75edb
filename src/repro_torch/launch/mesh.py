"""Production mesh definitions: the counterpart of ``repro/launch/mesh.py``.

Single pod: (16, 16) = 256 devices ("data", "model").
Multi-pod:  (2, 16, 16) = 512 devices ("pod", "data", "model") — the pod
axis carries outer data parallelism (training) / replica groups (serving),
while "model" stays inside the pod.

A ``DeviceMesh`` needs a process group of its size. In the dry run the
meshes sit on a fake one (``torch.distributed``'s "fake" backend: every
rank's collectives return at once, with the right shapes), the counterpart
of the reference's 512 host placeholder devices. Training runs on a real
one (``init_process_group``: gloo on the CPU, NCCL on the card, one process
per rank) through ``make_mesh``, which refuses a fake group unless the dry
run asks for one. Defined as functions, so that importing this module
touches no process-group state.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import require
from repro_torch.distributed.sharding import is_fake, mesh_device_type


def fake_store():
    """The store of a fake process group. ``FakeStore`` lives in
    ``torch.testing._internal``; this is the one place that imports it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def init_fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0.
    An initialised group of that size is kept; another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is initialised, not {world_size}")
        return
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group for the block, destroyed after it."""
    init_fake_process_group(world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for a process group's address."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_process_group(device="cuda", *, rank=None, world_size=None,
                       init_method=None) -> torch.device:
    """A real process group, and this rank's device: gloo for a "cpu"
    ``device``, NCCL on ``cuda:LOCAL_RANK`` for a "cuda" one. ``rank`` and
    ``world_size`` default to torchrun's ``RANK`` and ``WORLD_SIZE`` (0 and
    1 without them). ``init_method`` defaults to "env://" (torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``), or, for one rank outside
    torchrun, a free port on localhost."""
    device = require(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ
                       or world_size > 1 else f"tcp://localhost:{free_port()}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              if device.index is None else device.index)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size, device_id=device)
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    return device


def make_mesh(shape, axes, *, fake: bool = False):
    """A mesh over the initialised process group, which must have exactly
    its ranks; its device type is the group's (``sharding.mesh_device_type``).
    No group, another size, or a fake group where ``fake`` is not set (only
    the dry run sets it) raises."""
    if not dist.is_initialized():
        raise RuntimeError(f"a {' x '.join(map(str, shape))} mesh needs an "
                           f"initialised process group of {math.prod(shape)} "
                           f"ranks (torchrun, or init_process_group)")
    if is_fake() and not fake:
        raise RuntimeError("the process group is fake: its collectives "
                           "compute nothing; initialise a gloo or NCCL one")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a {' x '.join(map(str, shape))} mesh needs "
                           f"{math.prod(shape)} ranks; the process group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def production_layout(multi_pod: bool = False):
    """(shape, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh on a fake process group of its size
    (initialised here if none is)."""
    shape, axes = production_layout(multi_pod)
    init_fake_process_group(math.prod(shape))
    return make_mesh(shape, axes, fake=True)


def make_host_mesh(data: int = 1, model: int = 1):
    """Small mesh over the initialised process group (fake in the dry run,
    gloo in a multi-process test); a fake one of data x model ranks when
    none is."""
    if not dist.is_initialized():
        init_fake_process_group(data * model)
    return make_mesh((data, model), ("data", "model"), fake=True)
