"""Whisper-style encoder-decoder (the audio family) in PyTorch: the
counterpart of ``repro/models/whisper.py``.

The conv frontend is a stub, as in the reference: the caller gives
precomputed frame features (B, S_enc, frontend_dim) and the model owns one
linear projection of them. Positions are learned embeddings (rope_theta 0),
norms are LayerNorm with bias, MLPs are non-gated GELU. The encoder's
attention and the decoder's cross attention are plain PyTorch (no TPU kernel
computed them); the decoder's causal self-attention in prefill goes through
the flash-prefill op. Cross K/V are computed once at prefill and never
change; decode updates the self-attention cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights drawn from ``generator`` (on ``device``) with the JAX
    fan-in scales, each leaf in its dtype."""
    normal, ones, zeros = tfm.drawers(generator, tfm._DTYPES[cfg.param_dtype],
                                      require_device(device))
    d, fd = cfg.d_model, cfg.frontend_dim

    def ln(*n):
        return {"scale": ones((*n, d)), "bias": zeros((*n, d))}

    def stack(n, cross):
        p = {"attn": tfm.init_attention(cfg, normal, ones, n=n),
             "mlp": tfm.init_mlp(normal, zeros, n, d, cfg.d_ff, gated=False),
             "ln1": ln(n), "ln2": ln(n)}
        if cross:
            p["xattn"] = tfm.init_attention(cfg, normal, ones, n=n,
                                            cross=True)
            p["ln3"] = ln(n)
        return p

    return {
        "embedding": tfm.init_embedding(cfg, normal),
        "frontend": normal((fd, d), fd ** -0.5),
        "pos_enc": normal((cfg.encoder_seq_len, d), 0.02),
        "pos_dec": normal((cfg.max_position_embeddings, d), 0.02),
        "enc_layers": stack(cfg.encoder_layers, False),
        "dec_layers": stack(cfg.num_layers, True),
        "enc_norm": ln(),
        "final_norm": ln(),
    }


def _ln(p, x, eps):
    return cm.layer_norm(x, p["scale"], p["bias"], eps)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, frontend_dim) -> (B, S_enc, d), full
    (non-causal) attention."""
    x = frames.to(params["frontend"].dtype) @ params["frontend"]
    x = x + params["pos_enc"][None, :x.shape[1]]
    s = x.shape[1]
    full = torch.ones(1, 1, s, s, dtype=torch.bool, device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    for lp in cm.unstack(params["enc_layers"]):
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        q, k, v = cm._qkv(lp["attn"], cfg, h, positions)
        x = x + cm._out_proj(cm.mha(q, k, v, full, cfg.q_per_kv),
                             lp["attn"]["wo"])
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp(lp["mlp"], h)
    return _ln(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(lp, enc_out):
    return cm._proj(enc_out, lp["xattn"]["wk"]), \
        cm._proj(enc_out, lp["xattn"]["wv"])


def _cross_attend(lp, cfg, x, ck, cv):
    q = cm._proj(x, lp["xattn"]["wq"])
    mask = torch.ones(1, 1, x.shape[1], ck.shape[1], dtype=torch.bool,
                      device=x.device)
    return cm._out_proj(cm.mha(q, ck, cv, mask, cfg.q_per_kv),
                        lp["xattn"]["wo"])


# --------------------------------------------------------------------------
# decoder: train / prefill / decode
# --------------------------------------------------------------------------

def _dec_block(lp, cfg, x, enc_out, positions):
    h = _ln(lp["ln1"], x, cfg.norm_eps)
    x = x + cm.attention_train(lp["attn"], cfg, h, positions=positions)
    h = _ln(lp["ln2"], x, cfg.norm_eps)
    ck, cv = _cross_kv(lp, enc_out)
    x = x + _cross_attend(lp, cfg, h, ck, cv)
    h = _ln(lp["ln3"], x, cfg.norm_eps)
    return x + cm.mlp(lp["mlp"], h)


def forward_train(params, cfg: ModelConfig, tokens, frames,
                  remat: bool = True):
    """tokens (B, T), frames (B, S_enc, frontend_dim) -> logits (B, T, V).
    The encoder runs once, outside the decoder layers' remat."""
    enc_out = encode(params, cfg, frames)
    x = cm.embed(params["embedding"], tokens)
    t = x.shape[1]
    x = x + params["pos_dec"][None, :t]
    positions = torch.arange(t, device=x.device)[None, :]

    def body(x, lp):
        return _dec_block(lp, cfg, x, enc_out, positions), None

    x, _ = cm.layer_scan(body, x, params["dec_layers"], remat)
    x = _ln(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embedding"], x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    device = require_device(device)
    kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
           cfg.head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in (("k", kv), ("v", kv), ("ck", xkv), ("cv", xkv))}


def prefill(params, cfg: ModelConfig, tokens, frames, attention=None):
    """tokens (B, T), frames (B, S_enc, frontend_dim). Returns (last-token
    logits (B, V), cache {"k", "v": (L, B, T, KV, D), "ck", "cv":
    (L, B, S_enc, KV, D)}). ``attention`` is passed to
    ``common.attention_prefill`` (default: the flash-prefill op)."""
    enc_out = encode(params, cfg, frames)
    x = cm.embed(params["embedding"], tokens)
    x = x + params["pos_dec"][None, :x.shape[1]]
    cache = {"k": [], "v": [], "ck": [], "cv": []}
    for i in range(cfg.num_layers):
        lp = tfm.layer(params["dec_layers"], i)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        a, k, v = cm.attention_prefill(lp["attn"], cfg, h, attention)
        x = x + a
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        ck, cv = _cross_kv(lp, enc_out)
        x = x + _cross_attend(lp, cfg, h, ck, cv)
        h = _ln(lp["ln3"], x, cfg.norm_eps)
        x = x + cm.mlp(lp["mlp"], h)
        for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
            cache[name].append(t)
    x = _ln(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = cm.unembed(params["embedding"], x)[:, 0]
    return logits, {k: torch.stack(v) for k, v in cache.items()}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos):
    """tokens, pos: (B,). Updates the self-attention cache in place. Returns
    (logits (B, V), cache)."""
    x = cm.embed(params["embedding"], tokens[:, None])
    x = x + params["pos_dec"][pos][:, None]
    for i in range(cfg.num_layers):
        lp = tfm.layer(params["dec_layers"], i)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = cm.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                      cache["v"][i], pos)
        x = x + a
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + _cross_attend(lp, cfg, h, cache["ck"][i], cache["cv"][i])
        h = _ln(lp["ln3"], x, cfg.norm_eps)
        x = x + cm.mlp(lp["mlp"], h)
    x = _ln(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embedding"], x)[:, 0], cache
