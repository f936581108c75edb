"""Shared PyTorch building blocks of the model zoo: the serving subset of
the JAX package's ``models/common.py``.

Parameters are nested dicts of tensors with the JAX tree's keys and layouts
(``wq``: (d, H, D), ``wo``: (H, D, d), stacked layers on a leading axis), so
weights carry over unchanged through ``repro_torch.params``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_prefill import ops as fp_ops

NEG_INF = -1e30


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
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


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
    return a.reshape(*a.shape[:-2], h * k) @ wo.reshape(h * k, d)


def repeat_kv(k, q_per_kv: int):
    """(B, S, KV, D) -> (B, S, KV*q_per_kv, D); head h reads kv head h // QPK."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def mha(q, k, v, mask, q_per_kv: int):
    """q: (B,T,H,D); k,v: (B,S,KV,D); mask broadcastable to (B,1,T,S).
    Products run in the operands' promoted dtype, as in JAX; the softmax's
    probabilities are cast to q's dtype first."""
    k = repeat_kv(k, q_per_kv)
    v = repeat_kv(v, q_per_kv)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", *promoted(q, k)).float() * scale
    logits = torch.where(mask, logits, NEG_INF)
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
    counterpart of the flash-prefill kernel, as in the JAX package."""
    b, t, h, d = q.shape
    if t <= ATTN_CHUNK_T:
        return mha(q, k, v, causal_mask(t, window, q.device), q_per_kv)
    if t % bq:
        raise ValueError(f"T={t} must be a multiple of the chunk {bq}")
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
        outs.append(mha(q_i, k[:, k_start:k_end], v[:, k_start:k_end],
                        m[None, None], q_per_kv))
    return torch.cat(outs, dim=1)


def plain_prefill_attention(q, k, v, window: int = 0):
    """``chunked_causal_mha`` with the flash-prefill op's signature: the plain
    attention a caller may pass to ``attention_prefill``."""
    return chunked_causal_mha(q, k, v, q.shape[2] // k.shape[2], window)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     window: int = 0):
    """One-token decode against a dense (B, S, KV, D) cache.

    pos: (B,) absolute position of the new token. With a window the cache
    is a rolling buffer of ``window`` slots, position p at slot p % window.
    The cache is updated in place (JAX's functional ``.at[].set`` becomes an
    indexed write) and returned. Returns (out, cache_k, cache_v).
    """
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    slot = pos % window if window else pos
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    s = cache_k.shape[1]
    j = torch.arange(s, device=x.device)[None, :]
    if window:
        # rolling slot j holds absolute position pos - ((slot - j) % window)
        valid = pos[:, None] - (slot[:, None] - j) % window >= 0
    else:
        valid = j <= pos[:, None]
    out = mha(q, cache_k, cache_v, valid[:, None, None, :], cfg.q_per_kv)
    return _out_proj(out, p["wo"]), cache_k, cache_v


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
    if window and t >= window:
        shift = (t - window) % window
        k = torch.roll(k[:, t - window:], shift, dims=1)
        v = torch.roll(v[:, t - window:], shift, dims=1)
    elif window:
        k = F.pad(k, (0, 0, 0, 0, 0, window - t))
        v = F.pad(v, (0, 0, 0, 0, 0, window - t))
    return _out_proj(out, p["wo"]), k, v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp(p, x):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed(p, tokens):
    return p["tok"][tokens]


def unembed(p, x):
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return x @ w
