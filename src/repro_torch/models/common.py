"""Shared PyTorch building blocks of the model zoo: the counterpart of the
JAX package's ``models/common.py`` for serving and training.

Parameters are nested dicts of tensors with the JAX tree's keys and layouts
(``wq``: (d, H, D), ``wo``: (H, D, d), stacked layers on a leading axis), so
weights carry over unchanged through ``repro_torch.params``. Leaves are made
by ``transformer.Drawers``, which also states their logical axes (the
reference's ``Param`` and ``Initializer``). ``act_shard`` marks the
activations the reference constrains, with its logical names; it is the
identity unless a launcher installs rules (``distributed.sharding``).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_prefill import ops as fp_ops

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Activation-sharding hook (set by the launcher; no-op otherwise)
# --------------------------------------------------------------------------

_ACTIVATION_RULES: Callable | None = None


def set_activation_rules(fn: Callable | None):
    """fn(x, logical_axes) -> x, typically a ``DTensor.redistribute``."""
    global _ACTIVATION_RULES
    _ACTIVATION_RULES = fn


def act_shard(x, *logical):
    if _ACTIVATION_RULES is None:
        return x
    return _ACTIVATION_RULES(x, logical)


_SHARDED_OPS = None


def set_sharded_ops(ops):
    """``ops`` (or None) gives the steps that DTensors take their own way
    (the dry run's, through ``distributed.sharding``):
      * ``write_rows(cache, slot, rows)``: the decode write, which DTensor
        refuses in place on a sharded cache;
      * ``head_layout(y, h)``: a projection's flat heads laid out so that
        they split into ``h`` heads;
      * ``pinned(t)``: a flattened weight or activation whose gradient must
        come back in its own layout;
      * ``embedding(tokens, table)`` and ``take_along_last(logits,
        labels)``: the lookups on a vocab-sharded table or logits;
      * ``whole(x)``: x's whole value as a plain tensor on every device (the
        MoE dispatch and combine, whose sort, search and indexed writes
        DTensor has no sharding for, run on it);
      * ``attention(attend, q, k, v, mask, seq_logical)``: ``mha``'s core
        on each device's batch rows and heads;
      * ``heads_parallel(fn, ins, outs)``: mamba2's scans, likewise;
      * ``time_local(fn)``: ``fn(x (B, T, ..., W), *params (..., W))``,
        the causal convs and the window cache's roll, on each device's
        batch rows and channels, the time dim whole;
      * ``gathered_layer(body)``: a layer's body that first gathers the
        layer's parameters over the data axes (FSDP's per-layer gather);
      * ``reduce_partial(y)``: y with its partial sums reduced;
      * ``alike(y, x)``: a plain y computed from ``whole`` values, back as
        a replicated DTensor on x's mesh.
    """
    global _SHARDED_OPS
    _SHARDED_OPS = ops


def sharded_ops():
    """The ops ``set_sharded_ops`` installed, or None."""
    return _SHARDED_OPS


def set_layer_scan_unroll(v: bool):
    """A no-op kept for the reference's callers: ``layer_scan`` is already a
    Python loop over the layers, so every layer's ops are dispatched (and
    counted) one by one. The reference unrolls its ``lax.scan`` for the
    same effect in XLA's cost analysis."""
    del v


# --------------------------------------------------------------------------
# Layer stack (the counterpart of ``lax.scan`` over stacked layers)
# --------------------------------------------------------------------------

def unstack(tree):
    """A stacked layer tree -> one tree per layer. Each leaf is unbound
    once along its leading axis, so its gradient is one stack of the
    layers' gradients rather than a sum of full-size scatters."""
    per_leaf = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def layer_scan(body, x, layers, remat: bool = False):
    """``body(x, lp) -> (x, y)`` over each layer ``lp`` of the stacked tree
    ``layers``, in order. Returns (x, [y per layer]). With ``remat`` each
    layer's activations are recomputed in the backward pass
    (``jax.checkpoint`` of the scanned body in the reference)."""
    if _SHARDED_OPS is not None:
        body = _SHARDED_OPS.gathered_layer(body)
    ys = []
    for lp in unstack(layers):
        if remat:
            x, y = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, y = body(x, lp)
        ys.append(y)
    return x, ys


# --------------------------------------------------------------------------
# Normalisation
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    """Sum of squares accumulated in f32, then (x * r) * scale in f32."""
    dtype = x.dtype
    xf = x.float()
    ss = (xf * xf).sum(-1, keepdim=True)
    r = torch.rsqrt(ss / x.shape[-1] + eps)
    return ((xf * r) * scale.float()).to(dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm with bias, computed in f32 and cast back to x's dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(dtype)


# --------------------------------------------------------------------------
# Rotary position embedding (NeoX rotate-half convention)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, D); positions broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., T, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, optional qk-norm)
# --------------------------------------------------------------------------

def _proj(x, w):
    """(B, T, d) @ (d, H, D) -> (B, T, H, D), contiguous."""
    d, h, k = w.shape
    y = x @ _pinned(w.reshape(d, h * k))
    if _SHARDED_OPS is not None:
        y = _SHARDED_OPS.head_layout(y, h)
    return y.reshape(*x.shape[:-1], h, k)


def reduced(y):
    """A row-parallel product's output; as a DTensor, its partial sums
    reduced where they are made (Megatron's all-reduce), so that the
    residual stream keeps its layout. DTensor would otherwise scatter them
    over the tokens, a layout whose strided shards it plans at great cost
    on a 2 x 16 x 16 mesh."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.reduce_partial(y)
    return y


def _pinned(t):
    """t itself; a DTensor pinned to its layout, so that its gradient comes
    back in it (``set_sharded_ops``)."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.pinned(t)
    return t


def _qkv(p, cfg: ModelConfig, x, positions, rope: bool = True):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope and cfg.rope_theta > 0:  # rope_theta == 0 -> positions are learned
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def promoted(*xs):
    """The tensors in the dtype JAX would compute a product of them in: a
    bf16 activation against an f32 state is an f32 product there, while
    ``torch.matmul`` and ``einsum`` refuse mixed dtypes."""
    dtype = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return tuple(x.to(dtype) for x in xs)


def _out_proj(a, wo):
    """(..., H, D) @ (H, D, d) -> (..., d), in their promoted dtype."""
    h, k, d = wo.shape
    a, wo = promoted(a, wo)
    return reduced(_pinned(a.reshape(*a.shape[:-2], h * k))
                   @ _pinned(wo.reshape(h * k, d)))


def repeat_kv(k, q_per_kv: int):
    """(B, S, KV, D) -> (B, S, KV*q_per_kv, D); head h reads kv head h // QPK."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def mha(q, k, v, mask, q_per_kv: int, seq_logical=None):
    """q: (B,T,H,D); k,v: (B,S,KV,D); mask broadcastable to (B,1,T,S).
    Products run in the operands' promoted dtype, as in JAX; the softmax's
    probabilities are cast to q's dtype first. ``seq_logical`` names the
    KV sequence dim's logical axis (decode: "kv_seq", which keeps attention
    on a sequence-sharded cache)."""
    k = repeat_kv(k, q_per_kv)
    v = repeat_kv(v, q_per_kv)
    if seq_logical is not None:
        k = act_shard(k, "batch", seq_logical, None, None)
        v = act_shard(v, "batch", seq_logical, None, None)
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.attention(_attend, q, k, v, mask, seq_logical)
    return _attend(q, k, v, mask, seq_logical)


def _attend(q, k, v, mask, seq_logical=None):
    """``mha`` once K/V have q's heads."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", *promoted(q, k)).float() * scale
    logits = torch.where(mask, logits, NEG_INF)
    if seq_logical is not None:
        logits = act_shard(logits, "batch", None, None, seq_logical)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", *promoted(probs, v))


def causal_mask(t: int, window: int = 0, device=None):
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    m = j <= i
    if window:
        m &= j > i - window
    return m[None, None]  # (1,1,T,S)


# above this length the plain path attends chunk by chunk so the (T, S)
# logits tensor never materialises whole
ATTN_CHUNK_T = 2048
ATTN_CHUNK_Q = 1024


def chunked_causal_mha(q, k, v, q_per_kv: int, window: int = 0,
                       bq: int = ATTN_CHUNK_Q):
    """Exact causal attention in plain PyTorch: a loop over query chunks, each
    attending only to its causal (and window-limited) key prefix. The plain
    counterpart of the flash-prefill kernel, as in the JAX package. Under
    autograd each chunk's logits are recomputed in the backward pass, so
    only one chunk's (bq, kv) buffer is ever live."""
    b, t, h, d = q.shape
    if t <= ATTN_CHUNK_T:
        return mha(q, k, v, causal_mask(t, window, q.device), q_per_kv)
    if t % bq:
        raise ValueError(f"T={t} must be a multiple of the chunk {bq}")
    attend = mha
    if torch.is_grad_enabled() and q.requires_grad:
        attend = functools.partial(checkpoint, mha, use_reentrant=False)
    outs = []
    for i in range(t // bq):
        q_i = q[:, i * bq:(i + 1) * bq]
        k_end = (i + 1) * bq
        k_start = 0
        if window:
            k_start = max(0, i * bq - window + 1) // 128 * 128
        ii = i * bq + torch.arange(bq, device=q.device)[:, None]
        jj = k_start + torch.arange(k_end - k_start, device=q.device)[None, :]
        m = jj <= ii
        if window:
            m &= jj > ii - window
        outs.append(attend(q_i, k[:, k_start:k_end], v[:, k_start:k_end],
                           m[None, None], q_per_kv))
    return torch.cat(outs, dim=1)


def _attn_layout(q, k, v, q_per_kv):
    """Train/prefill attention layout, applied once per layer: K/V repeated
    to the query heads, then all three marked with the attention layout
    (heads over "model" when divisible, else batch-parallel), so they get
    the same verdict, as in the reference."""
    k = repeat_kv(k, q_per_kv)
    v = repeat_kv(v, q_per_kv)
    q = act_shard(q, "attn_batch", None, "attn_heads", None)
    k = act_shard(k, "attn_batch", None, "attn_heads", None)
    v = act_shard(v, "attn_batch", None, "attn_heads", None)
    return q, k, v


def plain_prefill_attention(q, k, v, window: int = 0):
    """The reference's prefill attention with the flash-prefill op's
    signature: the attention layout, then the plain ``chunked_causal_mha``
    (the same numbers as repeating K/V chunk by chunk). The plain attention
    a caller may pass to ``attention_prefill``."""
    q, k, v = _attn_layout(q, k, v, q.shape[2] // k.shape[2])
    return chunked_causal_mha(q, k, v, 1, window)


def attention_train(p, cfg: ModelConfig, x, window: int = 0,
                    positions=None):
    """Full-sequence causal (optionally windowed) attention for training:
    K/V repeated to the query heads once, then the plain
    ``chunked_causal_mha``. Neither hand-written kernel runs here: they
    have no backward."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    q, k, v = _attn_layout(q, k, v, cfg.q_per_kv)
    out = chunked_causal_mha(q, k, v, 1, window)
    out = act_shard(out, "batch", None, None, None)
    return _out_proj(out, p["wo"])


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     window: int = 0, seq_logical="kv_seq"):
    """One-token decode against a dense (B, S, KV, D) cache.

    pos: (B,) absolute position of the new token. With a window the cache
    is a rolling buffer of ``window`` slots, position p at slot p % window.
    The cache is updated in place (JAX's functional ``.at[].set`` becomes an
    indexed write) and returned. ``seq_logical`` marks the cache's sequence
    dim for ``mha`` (whisper's decoder leaves it unmarked, as its reference
    does). Returns (out, cache_k, cache_v).
    """
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    slot = pos % window if window else pos
    write_rows(cache_k, slot, k[:, 0])
    write_rows(cache_v, slot, v[:, 0])
    s = cache_k.shape[1]
    j = torch.arange(s, device=x.device)[None, :]
    if window:
        # rolling slot j holds absolute position pos - ((slot - j) % window)
        valid = pos[:, None] - (slot[:, None] - j) % window >= 0
    else:
        valid = j <= pos[:, None]
    out = mha(q, cache_k, cache_v, valid[:, None, None, :], cfg.q_per_kv,
              seq_logical)
    return _out_proj(out, p["wo"]), cache_k, cache_v


def write_rows(cache, slot, rows):
    """cache[b, slot[b]] = rows[b] for every b, in place: a decode step's
    KV write, the reference's ``.at[bidx, slot].set``."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.write_rows(cache, slot, rows)
    write_rows_plain(cache, slot, rows)


def write_rows_plain(cache, slot, rows):
    """``write_rows`` on a plain tensor: one indexed write."""
    bidx = torch.arange(rows.shape[0], device=rows.device)
    cache[bidx, slot] = rows.to(cache.dtype)


def attention_prefill(p, cfg: ModelConfig, x, attention=None,
                      window: int = 0):
    """Prefill: full causal (optionally windowed) pass that also returns the
    populated cache.

    ``attention(q, k, v, window)`` computes the attention itself. It
    defaults to the flash-prefill op: the hand-written kernel on a CUDA
    tensor, its plain version on a CPU tensor. Returns (out, k_cache,
    v_cache): caches (B, T, KV, D), or with a window the last ``window``
    positions in rolling-buffer layout (position p at slot p % window),
    zero-padded to ``window`` slots when T is shorter.
    """
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = (attention or fp_ops.flash_prefill)(q, k, v, window)
    out = act_shard(out, "batch", None, None, None)
    if window:
        rolled = functools.partial(_window_cache, window=window)
        if _SHARDED_OPS is not None:
            rolled = _SHARDED_OPS.time_local(rolled)
        k, v = rolled(k), rolled(v)
    return _out_proj(out, p["wo"]), k, v


def _window_cache(x, window: int):
    """The rolling-window cache of x (B, T, ...): its last ``window``
    positions at slot p % window, zero-padded to ``window`` slots when T is
    shorter."""
    t = x.shape[1]
    if t >= window:
        return torch.roll(x[:, t - window:], (t - window) % window, dims=1)
    return F.pad(x, (0, 0, 0, 0, 0, window - t))


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp(p, x):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return reduced(h @ p["w_down"])
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return reduced(h @ p["w_down"]) + p["b_down"]


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed(p, tokens):
    """Rows of the token table. ``F.embedding``'s backward sums repeated
    tokens' gradients in a fixed order (indexing's does not on the CPU), so
    a training step gives the same numbers on every run."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.embedding(tokens, p["tok"])
    return F.embedding(tokens, p["tok"])


def whole(x):
    """x itself, or its whole value as a plain tensor on every device when
    it is a DTensor (``set_sharded_ops``)."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.whole(x)
    return x


def alike(y, x):
    """y itself; a plain y made from ``whole`` values, as a replicated
    DTensor on x's mesh when x is a DTensor, so that its gradient comes
    back plain (``set_sharded_ops``)."""
    if _SHARDED_OPS is not None:
        return _SHARDED_OPS.alike(y, x)
    return y


def unembed(p, x):
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    logits = x @ w
    axes = ("batch",) + (None,) * (logits.ndim - 2) + ("vocab",)
    return act_shard(logits, *axes)


def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Mean next-token cross entropy in f32 with a z-loss on the log
    normaliser; with ``mask``, the mean over the masked-in positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if _SHARDED_OPS is not None:
        ll = _SHARDED_OPS.take_along_last(logits, labels)
    else:
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll + z_loss * torch.square(lse)
    if mask is not None:
        loss = loss * mask
        return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)
