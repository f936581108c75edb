"""Logical-axis sharding rules -> DTensor placements (MaxText-style): the
counterpart of ``repro/distributed/sharding.py``.

Params carry logical axes (``models.api.param_axes``); this module
translates them onto a ``DeviceMesh`` with the reference's
divisibility-aware rules: a logical axis maps to its mesh axis only if the
dimension size is divisible by the mesh-axis extent and the mesh axis has
not already been consumed by an earlier dimension of the same tensor.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, a mesh axis name, a tuple of names, or None, trailing Nones
trimmed. ``placements`` turns it into DTensor placements: each mesh dim
that shards tensor dim d is ``Shard(d)``, every other ``Replicate()``; a
dim sharded over two mesh axes is ``Shard(d)`` on both.

Modes:
  * serve: pure tensor/expert parallel over "model"; params replicated over
    "data"/"pod" (each data-parallel replica group serves its own traffic).
  * train: TP over "model" + FSDP over "data" (embed-dim sharding of 2D+
    weights and optimizer state = ZeRO-3), batch over ("pod", "data").
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models import common as cm

# logical axis -> mesh axis (serve mode)
SERVE_RULES = {
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "rnn": "model",
    "ssm_heads": "model",
    "embed": None,
    "frontend": None,
    "layers": None,
}

# train mode adds FSDP: the embed dim of big tensors shards over "data"
TRAIN_RULES = dict(SERVE_RULES, embed="data")

# activation logical axes
ACT_RULES = {
    "batch": ("pod", "data"),
    "expert": "model",
    "vocab": "model",     # keep logits vocab-sharded through the CE loss
    "kv_seq": "model",    # decode attention stays on the seq-sharded cache
}


def axis_sizes(mesh) -> dict:
    """{mesh axis name: extent}: a ``DeviceMesh``'s, or ``mesh.shape`` where
    that is already such a dict (as a JAX mesh's is)."""
    if isinstance(mesh.shape, dict):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, name) -> int:
    sizes = axis_sizes(mesh)
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes.get(n, 1)
        return out
    return sizes.get(name, 1)


def spec_for(mesh, shape, axes, rules, min_size_to_shard: int = 2) -> tuple:
    """The spec of one tensor, divisibility-aware."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        mesh_ax = rules.get(logical) if logical is not None else None
        if (mesh_ax is None or mesh_ax in used
                or mesh_ax not in sizes
                or dim % sizes[mesh_ax] != 0
                or dim < min_size_to_shard):
            out.append(None)
        else:
            out.append(mesh_ax)
            used.add(mesh_ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec) -> list:
    """DTensor placements, one per mesh dim, of a spec."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the counterpart of JAX's ``NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_shardings(mesh, params, axes, rules=SERVE_RULES):
    """Sharding tree matching the params tree."""
    return _tree_map(
        lambda p, a: NamedSharding(mesh, spec_for(mesh, p.shape, a, rules)),
        params, axes)


def replicated(mesh):
    return NamedSharding(mesh, ())


def batch_sharding(mesh, shape) -> NamedSharding:
    """Shard dim 0 (global batch) over every data-like mesh axis present."""
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = mesh_axis_size(mesh, data_axes)
    if not data_axes or shape[0] % n != 0:
        # try "data" alone before giving up
        if "data" in sizes and shape[0] % sizes["data"] == 0:
            return NamedSharding(mesh, ("data",))
        return NamedSharding(mesh, ())
    return NamedSharding(mesh, (data_axes,))


def cache_shardings(mesh, cache_specs_tree, batch: int):
    """KV/state caches: batch dim (axis 1 by convention) over data axes,
    head-like dims over model when divisible."""
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = mesh_axis_size(mesh, data_axes)
    n_model = sizes.get("model", 1)

    def one(spec):
        shape = spec.shape
        names = [None] * len(shape)
        if len(shape) >= 2 and shape[1] == batch and batch % n_data == 0 \
                and n_data > 1:
            names[1] = data_axes
        # shard the largest remaining dim over model if divisible
        cand = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in cand:
            if names[i] is None and shape[i] % n_model == 0 \
                    and shape[i] >= n_model and n_model > 1 and i != 1:
                names[i] = "model"
                break
        while names and names[-1] is None:
            names.pop()
        return NamedSharding(mesh, tuple(names))

    return _tree_map(one, cache_specs_tree)


def distribute(tree, shardings):
    """Each tensor of ``tree`` (or ``tree`` itself, a tensor) as a DTensor
    under its sharding; meta tensors stay meta: nothing is allocated."""
    return _tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                     tree, shardings)


# --------------------------------------------------------------------------
# activation-sharding hook
# --------------------------------------------------------------------------

def _as_dtensor(x, mesh):
    """A plain tensor made inside a model (a mask, a position table) as a
    replicated DTensor, as ``implicit_replication`` treats it."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _full(x):
    """x's whole value on every device: a DTensor is gathered."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim).to_local()
    return x


def alike(y, x):
    """A plain y (computed on ``_full`` values) as a replicated DTensor on
    x's mesh, through the differentiable ``from_local``."""
    if isinstance(y, DTensor) or not isinstance(x, DTensor):
        return y
    return _as_dtensor(y, x.device_mesh)


def write_rows(cache, slot, rows):
    """``common.write_rows`` on a DTensor cache, on each device's shard.

    DTensor refuses the in-place indexed write on a cache sharded over the
    indexed dims (batch over "data", sequence over "model"), and its
    out-of-place form gathers the whole cache. Here each device gathers the
    new rows and slots (one token each) and writes the entries that fall in
    its own shard; an entry outside it rewrites the shard's own value, so
    every index is written once and the write is exact."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(cache, DTensor):
        return cm.write_rows_plain(cache, slot, rows)
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    local = cache.to_local()
    rows, slot = _full(rows), _full(slot)
    rows = rows[offset[0]:offset[0] + shape[0]]
    for d in range(2, cache.ndim):
        rows = rows.narrow(d - 1, offset[d], shape[d])
    s = slot[offset[0]:offset[0] + shape[0]] - offset[1]
    inside = (s >= 0) & (s < shape[1])
    s = s.clamp(0, shape[1] - 1)
    b = torch.arange(shape[0], device=local.device)
    old = local[b, s]
    inside = inside.reshape(-1, *([1] * (old.ndim - 1)))
    local[b, s] = torch.where(inside, rows.to(local.dtype), old)


def head_layout(y, h: int):
    """A projection's output (..., h*k) with its last dim replicated over
    the mesh dims whose shards would cut a head (h not divisible by their
    count), so that it splits into (h, k). GSPMD reshards through such a
    reshape on its own; DTensor refuses to."""
    if not isinstance(y, DTensor):
        return y
    last = y.ndim - 1
    sizes = y.device_mesh.shape
    cut = [i for i, p in enumerate(y.placements)
           if isinstance(p, Shard) and p.dim == last]
    n = 1
    for i in cut:
        n *= sizes[i]
    if h % n == 0:
        return y
    return y.redistribute(y.device_mesh, [
        Replicate() if i in cut else p for i, p in enumerate(y.placements)])


def pinned(t):
    """t, its gradient redistributed back to t's own layout. A product may
    shard a replicated operand for free, and its gradient then comes back
    sharded where the (h, k) view that made the operand cannot split it."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def _local_span(x, dim: int):
    """(size, global offset) along ``dim`` of this device's shard of x."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return shape[dim], offset[dim]


def _vocab_parallel(x, dim: int, index, lookup):
    """``lookup(local x, local index)`` on this device's shard of x's
    ``dim``, Megatron-style: each device looks up the indices that fall in
    its shard and gives zeros for the rest, and the result is a partial sum
    over the mesh dims that shard ``dim`` (GSPMD's masked gather). DTensor's
    own strategy leaves a masked partial sum that its later reshards get
    wrong."""
    mesh = x.device_mesh
    vocab = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == dim]
    index = _as_dtensor(index, mesh)
    kept = [Replicate() if i in vocab or p.is_partial() else p
            for i, p in enumerate(index.placements)]
    index = index.redistribute(mesh, kept)
    size, offset = _local_span(x, dim)
    local = index.to_local().long() - offset
    inside = (local >= 0) & (local < size)
    # a table's row gradient sums the tokens of every batch shard
    grads = [Partial() if dim == 0 and isinstance(kept[i], Shard) else p
             for i, p in enumerate(x.placements)]
    out = lookup(x.to_local(grad_placements=grads),
                 local.clamp(0, size - 1))
    mask = inside.reshape(inside.shape + (1,) * (out.ndim - inside.ndim))
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    return DTensor.from_local(
        out, mesh, [Partial() if i in vocab else p
                    for i, p in enumerate(kept)], run_check=False)


def embedding(tokens, table):
    """``F.embedding(tokens, table)`` on a table whose vocab rows may be
    sharded (its other dims are gathered first)."""
    import torch.nn.functional as F
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    table = table.redistribute(table.device_mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in table.placements])
    return _vocab_parallel(table, 0, tokens, lambda t, i: F.embedding(i, t))


def take_along_last(logits, labels):
    """The cross entropy's target logit, ``logits[..., labels]`` at each
    position, on logits whose vocab dim may be sharded."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    logits = logits.redistribute(logits.device_mesh, [
        Replicate() if p.is_partial() else p for p in logits.placements])
    return _vocab_parallel(
        logits, logits.ndim - 1, labels,
        lambda x, i: torch.gather(x, -1, i[..., None])[..., 0])


def attention(attend, q, k, v, mask, seq_logical):
    """``attend(q, k, v, mask, seq_logical)`` (``common.mha``'s core, K/V
    with q's heads) laid out as GSPMD lays it out, and without the
    (batch x heads) merge of its products on DTensors sharded over both,
    whose strided shards DTensor plans at a cost that grows steeply with
    the mesh's rank:
      * q, k and v in one layout, their sequences whole (train, prefill):
        each device attends its own batch rows and heads;
      * else (decode on a cache sharded its own way): q keeps only its
        batch shards, every head of a row on each device, and the products
        follow the cache's layout."""
    local = all(isinstance(t, DTensor) for t in (q, k, v)) \
        and not isinstance(mask, DTensor) and mask.shape[0] == 1 \
        and q.placements == k.placements == v.placements \
        and not any(p.is_partial() or isinstance(p, Shard) and p.dim == 1
                    for p in q.placements)
    if local:
        from torch.distributed.tensor.experimental import local_map
        layout = list(q.placements)
        return local_map(lambda q, k, v: attend(q, k, v, mask),
                         out_placements=layout, in_placements=(layout,) * 3,
                         device_mesh=q.device_mesh)(q, k, v)
    if isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh, [
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in q.placements])
    return attend(q, k, v, mask, seq_logical)


def heads_parallel(fn, ins, outs):
    """``fn`` on each device's batch rows and heads, as ``attention`` runs
    attention: mamba2's scans, whose products on DTensors merge batch and
    heads into strided shards. ``ins`` and ``outs`` give each tensor's
    heads dim (None: no heads dim, the tensor replicated over "model") and
    whether its dim 0 is the batch. Heads go over "model" when it is free,
    divides them, and each tensor without a heads dim is the same for every
    head (mamba2's one group); else every device takes every head."""
    def run(*args):
        x = args[0]
        if not isinstance(x, DTensor):
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        mesh = x.device_mesh
        batch = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
        names = list(mesh.mesh_dim_names)
        model = names.index("model") if "model" in names else None
        groups = [a.shape[2] for a, (h, _) in zip(args, ins)
                  if h is None and a.ndim == 4]
        heads = model is not None and not batch[model] \
            and all(g == 1 for g in groups) \
            and x.shape[ins[0][0]] % mesh.size(model) == 0

        def layout(head_dim, batched):
            return [Shard(0) if batched and batch[i]
                    else Shard(head_dim) if heads and i == model
                    and head_dim is not None else Replicate()
                    for i in range(mesh.ndim)]

        return local_map(
            fn, out_placements=tuple(layout(*o) for o in outs),
            in_placements=tuple(layout(*i) for i in ins),
            device_mesh=mesh, redistribute_inputs=True)(*args)
    return run


def reduce_partial(y):
    """y with its partial sums reduced, its shards kept."""
    if not isinstance(y, DTensor) or not any(
            p.is_partial() for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, [
        Replicate() if p.is_partial() else p for p in y.placements])


def time_local(fn):
    """``fn(x, *params)`` on each device's batch rows and channels: x (B,
    T, ..., W) keeps its shards of B and W (its other dims whole), each
    param's last dim follows W. The causal convs pad the time dim and the
    window cache rolls it, which some DTensor versions cannot do on a
    DTensor."""
    def run(x, *params):
        if not isinstance(x, DTensor):
            return fn(x, *params)
        from torch.distributed.tensor.experimental import local_map
        last = x.ndim - 1
        layout = [p if isinstance(p, Shard) and p.dim in (0, last)
                  else Replicate() for p in x.placements]

        def follow(t):
            return [Shard(t.ndim - 1) if isinstance(p, Shard) and p.dim == last
                    else Replicate() for p in layout]

        return local_map(fn, out_placements=layout,
                         in_placements=(layout, *map(follow, params)),
                         device_mesh=x.device_mesh,
                         redistribute_inputs=True)(x, *params)
    return run


def gathered_layer(body):
    """``body(x, lp)`` run on the layer's parameters gathered over every
    mesh axis but "model": FSDP's per-layer all-gather (and, in the
    backward pass, its reduce-scatter), which XLA places inside the
    reference's layer scan. With the weights sharded over "model" alone,
    each product has one free placement; left to choose, DTensor may shard
    the tokens over "model" instead, a layout whose strided shards it plans
    at great cost on the 2 x 16 x 16 mesh."""
    def unsharded(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        return t.redistribute(t.device_mesh, [
            p if names[i] == "model" else Replicate()
            for i, p in enumerate(t.placements)])

    def run(x, lp):
        return body(x, _tree_map(unsharded, lp))
    return run


def install_activation_rules(mesh):
    """Route models' act_shard() calls to ``DTensor.redistribute`` (the
    reference's ``with_sharding_constraint``), and the steps that DTensors
    take their own way (``common.set_sharded_ops``) to this module."""
    sizes = axis_sizes(mesh)

    def attn_spec(x, logical):
        """attention layout: heads over `model` when divisible, else
        batch-parallel over (pod, data, model)."""
        bi = logical.index("attn_batch")
        hi = logical.index("attn_heads")
        data_axes = tuple(a for a in ("pod", "data") if a in sizes)
        n_model = sizes.get("model", 1)
        names = [None] * len(logical)
        if n_model > 1 and x.shape[hi] % n_model == 0:
            names[hi] = "model"
            if x.shape[bi] % mesh_axis_size(mesh, data_axes) == 0 \
                    and data_axes:
                names[bi] = data_axes if len(data_axes) > 1 else data_axes[0]
        else:
            full = data_axes + (("model",) if n_model > 1 else ())
            if full and x.shape[bi] % mesh_axis_size(mesh, full) == 0:
                names[bi] = full if len(full) > 1 else full[0]
            elif data_axes and x.shape[bi] % mesh_axis_size(
                    mesh, data_axes) == 0:
                names[bi] = data_axes if len(data_axes) > 1 else data_axes[0]
        return tuple(names)

    def spec(x, logical):
        if "attn_batch" in logical:
            return attn_spec(x, logical)
        names = []
        used = set()
        for i, l in enumerate(logical):
            m = ACT_RULES.get(l)
            if m is None:
                names.append(None)
                continue
            ms = tuple(a for a in (m if isinstance(m, tuple) else (m,))
                       if a in sizes and a not in used)
            if not ms or x.shape[i] % mesh_axis_size(mesh, ms) != 0:
                names.append(None)
            else:
                names.append(ms if len(ms) > 1 else ms[0])
                used.update(ms)
        return tuple(names)

    def fn(x, logical):
        return _as_dtensor(x, mesh).redistribute(
            mesh, placements(mesh, spec(x, logical)))

    cm.set_activation_rules(fn)
    cm.set_sharded_ops(SimpleNamespace(write_rows=write_rows,
                                       head_layout=head_layout,
                                       pinned=pinned,
                                       embedding=embedding,
                                       take_along_last=take_along_last,
                                       whole=_full, attention=attention,
                                       heads_parallel=heads_parallel,
                                       time_local=time_local,
                                       gathered_layer=gathered_layer,
                                       reduce_partial=reduce_partial,
                                       alike=alike))


def clear_activation_rules():
    cm.set_activation_rules(None)
    cm.set_sharded_ops(None)
