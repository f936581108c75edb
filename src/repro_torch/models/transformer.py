"""Dense decoder-only transformer (GQA, RoPE, SwiGLU, optional qk-norm) in
PyTorch: the counterpart of ``repro/models/transformer.py``. Covers the
dense family and the vlm family (pixtral's backbone; the vision frontend is
a stub projection over precomputed patch embeddings).

Parameters keep the JAX tree: per-layer leaves are stacked on a leading layer
axis, and a Python loop over that axis takes the place of ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import common as cm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def drawers(generator: torch.Generator, dtype, device):
    """(normal(shape, std), ones(shape), zeros(shape)): leaves made directly
    in ``dtype`` on ``device`` (no f32 temporary), the normal ones drawn from
    ``generator``, which must live on ``device``."""
    def normal(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=generator)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return normal, ones, zeros


def init_attention(cfg: ModelConfig, normal, ones, n: int | None = None,
                   cross: bool = False):
    """Stacked attention leaves of ``n`` layers (default ``cfg.num_layers``);
    a cross-attention has no qk-norm."""
    d, hd = cfg.d_model, cfg.head_dim
    n = cfg.num_layers if n is None else n
    attn = {
        "wq": normal((n, d, cfg.num_heads, hd), d ** -0.5),
        "wk": normal((n, d, cfg.num_kv_heads, hd), d ** -0.5),
        "wv": normal((n, d, cfg.num_kv_heads, hd), d ** -0.5),
        "wo": normal((n, cfg.num_heads, hd, d), (cfg.num_heads * hd) ** -0.5),
    }
    if cfg.qk_norm and not cross:
        attn["q_norm"] = ones((n, hd))
        attn["k_norm"] = ones((n, hd))
    return attn


def init_mlp(normal, zeros, n: int, d: int, f: int, gated: bool = True):
    """Stacked MLP leaves of ``n`` layers: SwiGLU, or a GELU MLP with biases
    (zeros) when not ``gated``."""
    if gated:
        return {"w_gate": normal((n, d, f), d ** -0.5),
                "w_up": normal((n, d, f), d ** -0.5),
                "w_down": normal((n, f, d), f ** -0.5)}
    return {"w_up": normal((n, d, f), d ** -0.5), "b_up": zeros((n, f)),
            "w_down": normal((n, f, d), f ** -0.5), "b_down": zeros((n, d))}


def init_embedding(cfg: ModelConfig, normal):
    embedding = {"tok": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        embedding["unembed"] = normal((cfg.d_model, cfg.vocab_size),
                                      cfg.d_model ** -0.5)
    return embedding


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights drawn from ``generator`` (which must live on
    ``device``): normal with std fan_in^-0.5 for projections, 0.02 for the
    token embedding, ones for norm scales, as the JAX initializer does."""
    normal, ones, zeros = drawers(generator, _DTYPES[cfg.param_dtype],
                                  require_device(device))
    d, n = cfg.d_model, cfg.num_layers
    p = {
        "embedding": init_embedding(cfg, normal),
        "layers": {
            "attn": init_attention(cfg, normal, ones),
            "mlp": init_mlp(normal, zeros, n, d, cfg.d_ff),
            "ln1": ones((n, d)),
            "ln2": ones((n, d)),
        },
        "final_norm": ones((d,)),
    }
    if cfg.num_patches:
        p["vision_proj"] = normal((cfg.frontend_dim, d),
                                  cfg.frontend_dim ** -0.5)
    return p


def layer(layers, i: int):
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# --------------------------------------------------------------------------
# forward (training)
# --------------------------------------------------------------------------

def _block(lp, cfg: ModelConfig, x, positions):
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + cm.attention_train(lp["attn"], cfg, h, positions=positions)
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + cm.mlp(lp["mlp"], h)


def embed_inputs(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Token embeddings (B, T, d); for a vlm, ``patch_embeds`` (B,
    num_patches, frontend_dim), projected by ``vision_proj``, take the place
    of the first num_patches of them."""
    x = cm.embed(params["embedding"], tokens)
    if cfg.num_patches and patch_embeds is not None:
        patches = patch_embeds.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([patches, x[:, cfg.num_patches:]], dim=1)
    return x


def forward_train(params, cfg: ModelConfig, tokens, patch_embeds=None,
                  remat: bool = True):
    """tokens: (B, T) -> logits (B, T, V)."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, lp):
        return _block(lp, cfg, x, positions), None

    x, _ = cm.layer_scan(body, x, params["layers"], remat)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x)


# --------------------------------------------------------------------------
# serving: dense-cache prefill / decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    device = require_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ffn(lp, cfg: ModelConfig, h):
    """One layer's feed-forward: the SwiGLU MLP."""
    return cm.mlp(lp["mlp"], h)


def prefill(params, cfg: ModelConfig, tokens, attention=None,
            patch_embeds=None):
    """Full prefill pass over tokens (B, T). Returns (last-token logits
    (B, V), cache {"k", "v": (L, B, T, KV, D)}). ``attention`` is passed to
    ``common.attention_prefill`` (default: the flash-prefill op). For a vlm,
    ``patch_embeds`` (B, num_patches, frontend_dim), projected by
    ``vision_proj``, take the place of the first num_patches embeddings."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    return prefill_layers(params, cfg, x, ffn, attention)


def prefill_layers(params, cfg: ModelConfig, x, ffn, attention=None):
    """The layer stack of a prefill from the embeddings x (B, T, d), with
    ``ffn(lp, cfg, h)`` as each layer's feed-forward. Returns what
    ``prefill`` returns."""
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, k, v = cm.attention_prefill(lp["attn"], cfg, h, attention)
        x = x + a
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp, cfg, h)
        ks.append(k)
        vs.append(v)
    x = cm.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(params["embedding"], x)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, ffn=ffn):
    """tokens: (B,) next input token; pos: (B,) int64, its absolute position.
    Updates the dense cache in place. Returns (logits (B, V), cache).
    ``ffn(lp, cfg, h)`` is each layer's feed-forward."""
    x = cm.embed(params["embedding"], tokens[:, None])
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = cm.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                      cache["v"][i], pos)
        x = x + a
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp, cfg, h)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x)[:, 0], cache
