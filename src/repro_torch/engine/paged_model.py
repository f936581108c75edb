"""Model glue for decoding against the paged KV pool: the counterpart of
``repro/engine/paged_model.py``, for the dense, vlm and moe families (the
ones with a KV cache).

Decode runs one token per active sequence against the pool through the
paged-attention op: the hand-written CUDA kernel on the card, its plain
version on the CPU. The pool is updated in place where the JAX code returns
a functionally updated copy (``.at[].set``); the functions still return it.

``PagedDecoder`` runs the dense and moe decode step on a padded batch size
of ``decode_buckets``, replayed from CUDA graphs on the card and eager on
the CPU; the JAX package has no counterpart (XLA compiles its step whole).
Nor has ``prefill`` (with ``stage_prefill``), which computes several whole
prompts in one pass and scatters their K/V into the pool; the reference's
executor prefills one prompt a call.
"""
from __future__ import annotations

import bisect
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import common as cm
from repro_torch.models import moe, transformer
from repro_torch.models.transformer import layer


def init_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
              dtype=torch.float32, device="cuda"):
    device = require_device(device)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


WRITE_LAYERS = 8   # layers of a prefill cache cast to the pool's dtype at once


def write_prefill(pool, cache, block_table, block_size: int):
    """Scatter one sequence's dense prefill cache into its pool blocks, in
    place: the reference's one prompt a call (the executor's passes go
    through ``prefill``, which writes only the prompts' own slots).

    cache: {"k": (L, 1, T, KV, D)}; block_table: (nb,) int64 where
    nb = ceil(T / block_size). T is padded up to a whole block. The cast to
    the pool's dtype is made ``WRITE_LAYERS`` layers at a time, so a long
    prompt's step holds its cache and a few layers' cast copy beside the
    pool, not a second copy of its whole cache.
    """
    nb = block_table.shape[0]
    for name in ("k", "v"):
        c = cache[name][:, 0]
        l, t, kvh, d = c.shape
        c = F.pad(c, (0, 0, 0, 0, 0, nb * block_size - t)).reshape(
            l, nb, block_size, kvh, d)
        dst = pool[name]
        for i in range(0, l, WRITE_LAYERS):
            dst[i:i + WRITE_LAYERS, block_table] = \
                c[i:i + WRITE_LAYERS].to(dst.dtype)
    return pool


def stage_prefill(prefills, block_size: int, scratch: int) -> np.ndarray:
    """The host side of a packed prefill pass over ``prefills`` (the
    executor's input, each a whole prompt): one int64 buffer of the
    prompts' tokens one after another (N), each token's position in its own
    prompt (N), then its pool slot (N): block * block_size + offset, the
    block from its own prompt's table. Where two prompts' tables share a
    block (a cached prefix), only the last prompt's token writes a slot, as
    per-prompt writes in turn would leave it; an earlier one writes into
    page ``scratch``, which nothing reads."""
    tokens, pos, slots = [], [], []
    for pf in prefills:
        n = len(pf["token_ids"])
        t = np.arange(n)
        table = np.asarray(pf["block_table"], np.int64)
        tokens.append(np.asarray(pf["token_ids"], np.int64))
        pos.append(t)
        slots.append(table[t // block_size] * block_size + t % block_size)
    slots = np.concatenate(slots)
    _, last = np.unique(slots[::-1], return_index=True)
    if len(last) < len(slots):
        keep = np.zeros(len(slots), bool)
        keep[len(slots) - 1 - last] = True
        slots = np.where(keep, slots, scratch * block_size)
    return np.concatenate(tokens + pos + [slots]).astype(np.int64)


def prefill(params, cfg: ModelConfig, pool, staged, lengths):
    """Several whole prompts of a dense or moe model in one pass, their K/V
    written into the pool in place: ``staged`` is ``stage_prefill``'s
    buffer on the pool's device, ``lengths`` the prompts' lengths in its
    order. Every layer runs once over all the prompts' rows, each prompt
    attending only to itself (``transformer.prefill_layers``); the K/V go
    into the pool by one scatter a ``WRITE_LAYERS`` group of layers for the
    whole pass. Returns the logits of each prompt's last token, (P, V)."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"packed prefill serves dense and moe, not "
                         f"{cfg.family!r}")
    n = sum(lengths)
    ffn = moe.ffn if cfg.family == "moe" else transformer.ffn
    x = cm.embed(params["embedding"], staged[None, :n])
    logits, cache = transformer.prefill_layers(
        params, cfg, x, ffn, lengths=lengths, positions=staged[n:2 * n])
    slots = staged[2 * n:]
    for name in ("k", "v"):
        c = cache.pop(name)[:, 0]                     # (L, N, KV, D)
        dst = pool[name].flatten(1, 2)                # (L, pages * BS, KV, D)
        for i in range(0, c.shape[0], WRITE_LAYERS):
            dst[i:i + WRITE_LAYERS, slots] = \
                c[i:i + WRITE_LAYERS].to(dst.dtype)
    return logits


def decode_step(params, cfg: ModelConfig, tokens, pos, pool, block_tables):
    """tokens/pos: (S,) int64; pool as init_pool; block_tables: (S, MB)
    int32. Writes each new token's K/V at (pos // BS, pos % BS) before the
    attention reads it, in place. Returns (logits (S, V), pool).

    Each layer's feed-forward is the SwiGLU MLP (dense, vlm) or, for moe,
    ``moe.ffn``: ``moe.moe_block`` in serving mode, dropless at every batch
    size (on the card the grouped expert kernel), its aux loss dropped."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(f"paged decode serves dense, vlm and moe, "
                                  f"not {cfg.family!r}")
    ffn = moe.ffn if cfg.family == "moe" else transformer.ffn
    x = cm.embed(params["embedding"], tokens[:, None])   # (S, 1, d)
    bs = pool["k"].shape[2]
    blk = torch.gather(block_tables, 1, (pos // bs)[:, None])[:, 0].long()
    off = pos % bs
    ctx = (pos + 1).to(torch.int32)
    # the rotary tables once a step, not twice a layer
    tables = (cm.rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
              if cfg.rope_theta > 0 else None)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        pk, pv = pool["k"][i], pool["v"][i]
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = cm._qkv(lp["attn"], cfg, h, pos[:, None], tables=tables)
        pk[blk, off] = k[:, 0].to(pk.dtype)
        pv[blk, off] = v[:, 0].to(pv.dtype)
        a = pa_ops.paged_attention(q[:, 0], pk, pv, block_tables, ctx)
        x = x + cm._out_proj(a, lp["attn"]["wo"])[:, None]
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp, cfg, h)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x)[:, 0], pool


@functools.lru_cache(maxsize=16)
def decode_buckets(max_slots: int) -> tuple:
    """The paged decode's padded batch sizes, a CUDA graph each on the card:
    1, 2, 4, 8, steps of 8 up to 64, then four steps an octave (80, 96, 112,
    128, 160, ...), ending at ``max_slots``. Each capture costs set-up time
    (about 0.12 s at Mistral-Small-24B's 40 layers on an H100) and each
    padding row little device time, hence the coarser steps at the top."""
    ladder, b = [1, 2, 4], 8
    while b < max_slots:
        ladder.append(b)
        b += max(8, 1 << (b.bit_length() - 3))
    return tuple(x for x in ladder if x < max_slots) + (max_slots,)


def decode_bucket(s: int, max_slots: int) -> int:
    """The smallest bucket of ``decode_buckets(max_slots)`` that holds ``s``
    sequences. A batch above ``max_slots`` raises: the executor holds no
    more slots than that."""
    if not 1 <= s <= max_slots:
        raise ValueError(f"decode batch of {s} outside 1..{max_slots}")
    buckets = decode_buckets(max_slots)
    return buckets[bisect.bisect_left(buckets, s)]


class PagedDecoder:
    """``decode_step`` of a dense or moe model on a padded bucket of
    ``decode_buckets(max_slots)``. On a CUDA pool (``graphed``) each bucket
    is captured in a CUDA graph, so a step costs the host one copy and one
    graph launch instead of every layer's kernel launches (some 60 a layer
    for dense, more for moe); on the CPU the same bucket runs eagerly.

    The step reads one static int32 buffer, for a bucket b laid out as
    tokens (b), positions (b) and block tables (b, mb), staged on the card
    through a pinned copy, and writes its f32 logits into one static
    (max_slots, V) buffer. The graphs share one memory pool and are
    captured largest first, here; none keeps a live tensor in that pool
    (its inputs and the logits lie outside it), so they replay in any order.
    The rows of a bucket past the real batch are padding: token 0 at
    position 0 (context 1) with every table entry on ``scratch``, a page of
    the pool that the allocator never hands out, so a padding row writes
    its K/V there and reads nothing else. ``stage`` fills every row of the
    bucket on every step, so a smaller batch never runs rows that an
    earlier, larger one left behind. Neither the paged-attention kernel
    (``kernels/paged_attention``) nor the serving MoE layer
    (``moe.moe_block``: shapes from n alone, the grouped kernel's expert
    offsets read on the device) reads anything back from the device, nor
    does any other op of the step, which is what lets it be captured.

    In a moe model the padding rows are routed like any other: serving is
    dropless, so they take no expert's row from a real one; each adds its k
    routed rows (token 0's experts, the same in every padding row) to the
    expert work, and leaves the real rows' arithmetic as it is.

    A capture launches nothing, so the kernel wrappers' calls during it are
    taken back off their ``launches`` (every wrapper in ``kernels.build``'s
    ``COUNTED``), and each replay adds them again: each count stays one per
    layer per decode.

    Only the families with a paged KV cache that the executor serves (dense,
    moe); the slot-state families (ssm, hybrid) are refused here, before
    anything touches a device.
    """

    def __init__(self, params, cfg: ModelConfig, pool, max_slots: int,
                 mb: int, scratch: int):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"paged decode serves dense and moe, not "
                             f"{cfg.family!r}")
        dev = pool["k"].device
        self.graphed = dev.type == "cuda"
        self.params, self.cfg, self.pool = params, cfg, pool
        self.max_slots, self.mb, self.scratch = max_slots, mb, scratch
        n = max_slots * (2 + mb)
        self._dev = torch.empty(n, dtype=torch.int32, device=dev)
        self._host = (torch.empty(n, dtype=torch.int32, pin_memory=True)
                      if self.graphed else self._dev)
        self._rows = self._host.numpy()      # the same memory, for numpy
        self.logits = torch.empty(max_slots, cfg.vocab_size,
                                  dtype=torch.float32, device=dev)
        # per bucket, its graph and the counted wrappers' calls a replay makes
        self.graphs, self.launches = {}, {}
        if not self.graphed:
            return
        # recorded once a replay's copy has left the pinned buffer
        self._copied = torch.cuda.Event()
        buckets = decode_buckets(max_slots)
        self.stage({"tokens": [], "pos": [], "block_tables": []}, buckets[-1])
        self._dev.copy_(self._host)
        stream = torch.cuda.Stream(dev)
        # one eager pass on the capture stream first: cuBLAS's workspace for
        # that stream, the paged kernel's shared-memory attribute and the
        # grouped kernel's device counter are set up outside the capture
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._run(buckets[-1])
        torch.cuda.current_stream(dev).wait_stream(stream)
        mempool = torch.cuda.graph_pool_handle()
        for b in reversed(buckets):
            g = torch.cuda.CUDAGraph()
            n0 = {fn: fn.launches for fn in build.COUNTED}
            with torch.cuda.graph(g, pool=mempool, stream=stream):
                self._run(b)
            self.graphs[b] = g
            self.launches[b] = {fn: fn.launches - c for fn, c in n0.items()}
            for fn, c in n0.items():
                fn.launches = c

    def _views(self, b: int):
        d = self._dev
        return d[:b], d[b:2 * b], d[2 * b:b * (2 + self.mb)].view(b, self.mb)

    def _run(self, b: int):
        toks, pos, tables = self._views(b)
        logits, _ = decode_step(self.params, self.cfg, toks.long(),
                                pos.long(), self.pool, tables)
        self.logits[:b].copy_(logits)

    def stage(self, dec: dict, b: int):
        """Write the decode batch ``dec`` (the executor's input) into the
        host side of the static buffer as bucket ``b``: its rows, then
        padding rows up to ``b``. When graphed, waits for the last replay's
        copy to have read the buffer first."""
        if self.graphed:
            self._copied.synchronize()
        s, mb = len(dec["tokens"]), self.mb
        rows = self._rows
        rows[:2 * b] = 0
        rows[:s] = dec["tokens"]
        rows[b:b + s] = dec["pos"]
        tables = rows[2 * b:b * (2 + mb)].reshape(b, mb)
        tables[:] = self.scratch
        for i, table in enumerate(dec["block_tables"]):
            tables[i, :len(table)] = table

    def run(self, b: int, s: int):
        """Run the staged bucket ``b``; returns the f32 logits of its first
        ``s`` rows: on the CPU eagerly, as a copy; when graphed, by copying
        the bucket from pinned memory asynchronously (``stage`` waits for it)
        and replaying its graph, as a view valid until the next replay."""
        if not self.graphed:
            self._run(b)
            return self.logits[:s].clone()
        n = b * (2 + self.mb)
        self._dev[:n].copy_(self._host[:n], non_blocking=True)
        self._copied.record()
        self.graphs[b].replay()
        for fn, c in self.launches[b].items():
            fn.launches += c
        return self.logits[:s]
