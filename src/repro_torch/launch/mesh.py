"""Production mesh definitions: the counterpart of ``repro/launch/mesh.py``.

Single pod: (16, 16) = 256 devices ("data", "model").
Multi-pod:  (2, 16, 16) = 512 devices ("pod", "data", "model") — the pod
axis carries outer data parallelism (training) / replica groups (serving),
while "model" stays inside the pod.

A ``DeviceMesh`` needs a process group of its size. The production meshes
sit on a fake one (``torch.distributed``'s "fake" backend: every rank's
collectives return at once, with the right shapes), the counterpart of the
reference's 512 host placeholder devices. Defined as functions, so that
importing this module touches no process-group state.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


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


def _make_mesh(shape, axes):
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh on a fake process group of its size
    (initialised here if none is)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_process_group(math.prod(shape))
    return _make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """Small mesh over the initialised process group (fake in the dry run,
    gloo in a multi-process test); a fake one of data x model ranks when
    none is."""
    if not dist.is_initialized():
        init_fake_process_group(data * model)
    return _make_mesh((data, model), ("data", "model"))
