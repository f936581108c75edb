"""Roofline terms of a dry-run step: the counterpart of
``repro/launch/hlo_analysis.py``, which reads XLA's compiled HLO. The port
has no HLO: it reads the aten and c10d functional ops that one device
dispatches while the step runs on DTensors (meta shards, a fake process
group), through ``DeviceCounter``, a ``TorchDispatchMode``.

Per device, from the ops on the local shards:
  * FLOPs: ``FlopCounterMode``'s formulas (its ``flop_registry``, with its
    decomposition of ops it has no formula for), op by op;
  * bytes accessed: each op's input and output bytes (views and the
    collectives excluded; an indexed read or write counts the rows it
    moves), where the reference read XLA's ``bytes accessed``;
  * collectives: every ``_c10d_functional`` all-reduce / all-gather /
    reduce-scatter / all-to-all, with its group size and its output's local
    bytes, weighted by the reference's ring-transfer factor.
A DTensor op is not counted itself: the mode lets DTensor run it, and
counts the local ops and collectives it turns into.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# c10d functional op -> the reference's HLO collective name
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
# ops that query a tensor, as FlopCounterMode lists them: no work
_QUERIES = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclass
class CollectiveStats:
    # bytes *moved per device* (ring model), by op kind
    by_kind: dict = field(default_factory=dict)
    count: int = 0
    counts_by_kind: dict = field(default_factory=dict)
    group_sizes: dict = field(default_factory=dict)  # kind -> sizes seen

    @property
    def total_bytes(self) -> float:
        return sum(self.by_kind.values())

    def add(self, kind: str, n: int, out_bytes: int):
        if n == 1:
            return
        if kind == "all-reduce":
            moved = 2.0 * (n - 1) / n * out_bytes
        elif kind == "all-gather":
            moved = (n - 1) / n * out_bytes       # output is the full gather
        elif kind == "reduce-scatter":
            moved = (n - 1) * out_bytes           # output is the shard
        elif kind == "all-to-all":
            moved = (n - 1) / n * out_bytes
        else:
            moved = float(out_bytes)
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + moved
        self.counts_by_kind[kind] = self.counts_by_kind.get(kind, 0) + 1
        sizes = self.group_sizes.setdefault(kind, [])
        if n not in sizes:
            sizes.append(n)
        self.count += 1


def _group_size(func, args, kwargs) -> int:
    """The participant count of a c10d functional collective: its
    ``group_size`` argument, else the size of its named group."""
    import torch.distributed.distributed_c10d as c10d
    values = dict(zip((a.name for a in func._schema.arguments), args))
    values.update(kwargs)
    if "group_size" in values:
        return int(values["group_size"])
    return c10d._resolve_process_group(values["group_name"]).size()


class DeviceCounter(TorchDispatchMode):
    """Counts what one device runs while active: FLOPs, bytes accessed and
    collectives of the ops on local tensors."""

    def __init__(self):
        super().__init__()
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import _get_current_dispatch_mode
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs it; its local ops come back
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types) or isinstance(
                _get_current_dispatch_mode(), FakeTensorMode):
            # DTensor's sharding propagation: global shapes, not device work
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            out = func(*args, **kwargs)
            if name not in _NOT_COLLECTIVES:
                self.collectives.add(_KINDS.get(name, name),
                                     _group_size(func, args, kwargs),
                                     _nbytes(out))
            return out
        if name in _QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        self.bytes_accessed += _op_bytes(func, name, args, kwargs, out)
        return out


# indexed reads and writes touch the rows they move, not the whole table
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put_", "index_copy_", "index_add_", "scatter_",
             "scatter_add_", "index_fill_"}


def _op_bytes(func, name, args, kwargs, out) -> int:
    """The bytes one op reads and writes: its inputs once and its output
    once; nothing for a view; for an indexed read or in-place write, the
    indices and twice the rows moved."""
    if func.is_view or name == "_unsafe_view":
        return 0
    if name in _GATHERS:
        return _nbytes(args[1:]) + 2 * _nbytes(out)
    if name in _SCATTERS:
        return _nbytes(args[1:]) + _nbytes(kwargs) + _nbytes(args[-1])
    return _nbytes(args) + _nbytes(kwargs) + _nbytes(out)


def collective_bytes(fn, *args, **kwargs) -> CollectiveStats:
    """The collectives one device runs in ``fn(*args, **kwargs)``."""
    with DeviceCounter() as counter:
        fn(*args, **kwargs)
    return counter.collectives


def roofline_terms(counter: DeviceCounter, hw, chips: int,
                   model_flops: float) -> dict:
    """The three §Roofline terms (seconds) + bookkeeping, from one device's
    counts of a dry-run step. The reference's XLA memory analysis has no
    counterpart here: its entries are None."""
    flops_dev = float(counter.flops)
    bytes_dev = float(counter.bytes_accessed)
    coll = counter.collectives

    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = bytes_dev / hw.hbm_bandwidth
    t_coll = coll.total_bytes / hw.link_bandwidth

    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    flops_global = flops_dev * chips
    return {
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll.total_bytes,
        "collectives_by_kind": dict(coll.by_kind),
        "collective_counts_by_kind": dict(coll.counts_by_kind),
        "collective_group_sizes": dict(coll.group_sizes),
        "num_collectives": coll.count,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_coll,
        "dominant": dominant,
        "step_time_est": max(t_compute, t_memory, t_coll),
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else 0.0),
        "memory": {"argument_bytes": None, "output_bytes": None,
                   "temp_bytes": None, "alias_bytes": None},
    }
