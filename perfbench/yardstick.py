"""The benchmark's arithmetic, kept apart from the program: the card's
published peaks, the percentile and censoring rules of the request records,
the byte and operation bounds of the port's two kernels, and a step's model
FLOPs. Frozen here so that a change to the program cannot move the yardstick.

The kernels' bound formulas are those ``chip_smoke.py`` prints its bounds
with: each input byte read once and each output byte written once; a bound
is the larger of bytes over bandwidth and operations over peak.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12          # tensor cores
PEAK_F32 = 67e12            # outside the tensor cores
BF16, F32, I32 = 2, 4, 4    # bytes


# --------------------------------------------------------------------------
# request records
# --------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile with linear interpolation (numpy's default, as
    the JAX package's benchmark harness computes its tails)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def censored(start: float, stop, end: float) -> float:
    """``stop - start``, or the age at the window's ``end`` when ``stop``
    never came inside it: a stall or a growing queue shows in the tail."""
    if stop is None or stop > end:
        return end - start
    return stop - start


# --------------------------------------------------------------------------
# kernel bounds
# --------------------------------------------------------------------------

def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops)


def paged_call(s: int, total_ctx: int, pages: int, heads: int,
               kv_heads: int, head_dim: int, pool_bytes: int = F32,
               q_bytes: int = BF16) -> tuple[int, int]:
    """(bytes, operations) of one paged decode attention call over ``s``
    sequences of summed context ``total_ctx`` in ``pages`` pages: the live
    K and V of the pool, q and the output, one int32 table entry per page
    and one length per sequence."""
    n_bytes = (total_ctx * kv_heads * head_dim * 2 * pool_bytes
               + 2 * s * heads * head_dim * q_bytes + I32 * pages + I32 * s)
    return n_bytes, 4 * heads * head_dim * total_ctx


def paged_call_s(*args, **kwargs) -> float:
    """``paged_call``'s bound in seconds; the operations at the f32 peak,
    as the kernel computes in f32."""
    return bound_s(*paged_call(*args, **kwargs), PEAK_F32)


def visible_pairs(t: int, window: int = 0) -> int:
    if not window:
        return t * (t + 1) // 2
    return sum(min(i + 1, window) for i in range(t))


def flash_call(b: int, t: int, heads: int, kv_heads: int, head_dim: int,
               window: int = 0, dtype_bytes: int = BF16) -> tuple[int, int]:
    """(bytes, operations) of one causal flash prefill call: q, k, v and
    the output once; QK^T and PV over the visible (query, key) pairs."""
    n_bytes = b * t * (2 * heads + 2 * kv_heads) * head_dim * dtype_bytes
    return n_bytes, 4 * head_dim * heads * b * visible_pairs(t, window)


def flash_call_s(t: int, heads: int, kv_heads: int, head_dim: int) -> float:
    n_bytes, n_ops = flash_call(1, t, heads, kv_heads, head_dim)
    return bound_s(n_bytes, n_ops, PEAK_BF16)


# --------------------------------------------------------------------------
# model sizes and FLOPs, from a configuration file's keys
# --------------------------------------------------------------------------

def layer_params(cfg: dict) -> tuple[int, int]:
    """(stored, active per token) parameters of one decoder layer: the
    attention projections, norms, and the feed-forward (every expert
    stored; the router and top-k experts active)."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    attn = d * h * hd * 2 + d * kv * hd * 2
    norms = 2 * d + (2 * hd if cfg.get("qk_norm") else 0)
    if cfg["family"] == "moe":
        e, k, f = (cfg["num_experts"], cfg["num_experts_per_tok"],
                   cfg["moe_intermediate_size"])
        expert = 3 * d * f
        return (attn + norms + d * e + e * expert,
                attn + norms + d * e + k * expert)
    ffn = 3 * d * cfg["intermediate_size"]
    return attn + norms + ffn, attn + norms + ffn


def weight_bytes(cfg: dict, rows_looked_up: int) -> int:
    """Bytes of bf16 weights a decode step of ``rows_looked_up`` sequences
    reads: every layer, the output head and final norm once, and of the
    token table only the rows looked up."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    stored, _ = layer_params(cfg)
    head = 0 if cfg.get("tie_word_embeddings") else d * v
    table = d * v if cfg.get("tie_word_embeddings") else rows_looked_up * d
    return BF16 * (cfg["num_hidden_layers"] * stored + head + d + table)


def decode_step_bytes(cfg: dict, ctx, pool_bytes: int = F32) -> int:
    """A decode step's byte bound: the weights once, the live K/V read and
    the new token's K/V written, for sequences at contexts ``ctx`` (each
    before the new token)."""
    kv_token = (2 * cfg["num_hidden_layers"] * cfg["num_key_value_heads"]
                * cfg["head_dim"] * pool_bytes)
    return weight_bytes(cfg, len(ctx)) + kv_token * (sum(ctx) + len(ctx))


def step_flops(cfg: dict, decode_ctx_sum: int, decode_seqs: int,
               prefill_lens) -> float:
    """Model FLOPs of one engine step: 2 x active parameters per token
    processed (the output head only for tokens whose logits are used: every
    decode token, the last of each prompt), plus causal attention (QK^T and
    PV): a decode token at context c attends c keys, a prompt of T tokens
    T(T+1)/2 pairs."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    n_layers, h, hd = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
                       cfg["head_dim"])
    _, active = layer_params(cfg)
    per_token = 2 * n_layers * active
    attn = 4 * n_layers * h * hd
    head = 2 * d * v
    flops = decode_seqs * (per_token + head) + attn * decode_ctx_sum
    for t in prefill_lens:
        flops += t * per_token + head + attn * visible_pairs(t)
    return float(flops)
