"""Model glue for decoding against the paged KV pool: the counterpart of
``repro/engine/paged_model.py``, for the dense, vlm and moe families (the
ones with a KV cache).

Decode runs one token per active sequence against the pool through the
paged-attention op: the hand-written CUDA kernel on the card, its plain
version on the CPU. The pool is updated in place where the JAX code returns
a functionally updated copy (``.at[].set``); the functions still return it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
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


def write_prefill(pool, cache, block_table, block_size: int):
    """Scatter one sequence's dense prefill cache into its pool blocks, in
    place.

    cache: {"k": (L, 1, T, KV, D)}; block_table: (nb,) int64 where
    nb = ceil(T / block_size). T is padded up to a whole block.
    """
    nb = block_table.shape[0]
    for name in ("k", "v"):
        c = cache[name][:, 0]
        l, t, kvh, d = c.shape
        c = F.pad(c, (0, 0, 0, 0, 0, nb * block_size - t))
        pool[name][:, block_table] = c.reshape(l, nb, block_size, kvh, d).to(
            pool[name].dtype)
    return pool


def decode_step(params, cfg: ModelConfig, tokens, pos, pool, block_tables):
    """tokens/pos: (S,) int64; pool as init_pool; block_tables: (S, MB)
    int32. Writes each new token's K/V at (pos // BS, pos % BS) before the
    attention reads it, in place. Returns (logits (S, V), pool).

    Each layer's feed-forward is the SwiGLU MLP (dense, vlm) or, for moe,
    ``moe.moe_block`` in serving mode (capacity_factor None: dropless at
    decode batch sizes), its aux loss dropped."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(f"paged decode serves dense, vlm and moe, "
                                  f"not {cfg.family!r}")
    ffn = moe.ffn if cfg.family == "moe" else transformer.ffn
    x = cm.embed(params["embedding"], tokens[:, None])   # (S, 1, d)
    bs = pool["k"].shape[2]
    blk = torch.gather(block_tables, 1, (pos // bs)[:, None])[:, 0].long()
    off = pos % bs
    ctx = (pos + 1).to(torch.int32)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        pk, pv = pool["k"][i], pool["v"][i]
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = cm._qkv(lp["attn"], cfg, h, pos[:, None])
        pk[blk, off] = k[:, 0].to(pk.dtype)
        pv[blk, off] = v[:, 0].to(pv.dtype)
        a = pa_ops.paged_attention(q[:, 0], pk, pv, block_tables, ctx)
        x = x + cm._out_proj(a, lp["attn"]["wo"])[:, None]
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp, cfg, h)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x)[:, 0], pool
