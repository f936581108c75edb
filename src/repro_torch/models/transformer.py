"""Dense decoder-only transformer (GQA, RoPE, SwiGLU, optional qk-norm) in
PyTorch: the counterpart of ``repro/models/transformer.py``. Covers the
dense family and the vlm family (pixtral's backbone; the vision frontend is
a stub projection over precomputed patch embeddings).

Parameters keep the JAX tree: per-layer leaves are stacked on a leading layer
axis, and a Python loop over that axis takes the place of ``lax.scan``.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import common as cm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

class Drawers:
    """The leaves of an init, made directly in ``dtype`` on ``device`` (no
    f32 temporary); ``normal`` draws from ``generator``, which must live on
    ``device``. On the meta device nothing is drawn or allocated: that is
    the reference's ``abstract`` init. Each maker also takes the leaf's
    logical sharding axes, the reference's ``Param`` axes ("layers" first on
    a stacked leaf); ``AxisNames`` returns those in place of the leaf, so an
    init states its tree once for both."""

    def __init__(self, generator: torch.Generator | None, dtype, device):
        self.generator, self.dtype, self.device = generator, dtype, device

    def normal(self, shape, std, axes):
        t = torch.empty(shape, dtype=self.dtype, device=self.device)
        return t.normal_(0.0, std, generator=self.generator)

    def ones(self, shape, axes):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape, axes):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def linspace(self, shape, lo: float, hi: float, axes):
        """Copies of the JAX initializer's linspace row: ``shape[-1]``
        values from lo to hi, made in f32 and cast."""
        row = torch.linspace(lo, hi, shape[-1], dtype=torch.float32,
                             device=self.device)
        return self.zeros(shape, axes).copy_(row.to(self.dtype).expand(shape))


class AxisNames:
    """Stands in for ``Drawers``: each maker returns the leaf's logical
    axes, checked against its rank as the reference's ``Param`` checks."""

    @staticmethod
    def _axes(shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"axes {axes} rank != shape {shape}")
        return tuple(axes)

    def normal(self, shape, std, axes):
        return self._axes(shape, axes)

    def ones(self, shape, axes):
        return self._axes(shape, axes)

    zeros = ones

    def linspace(self, shape, lo, hi, axes):
        return self._axes(shape, axes)


def drawers(cfg: ModelConfig, generator, device):
    """The ``Drawers`` of ``cfg``'s param dtype on ``device``."""
    return Drawers(generator, _DTYPES[cfg.param_dtype], require_device(device))


L = ("layers",)


def init_attention(cfg: ModelConfig, ini, n: int | None = None,
                   cross: bool = False):
    """Stacked attention leaves of ``n`` layers (default ``cfg.num_layers``);
    a cross-attention has no qk-norm."""
    d, hd = cfg.d_model, cfg.head_dim
    n = cfg.num_layers if n is None else n
    h, kv = cfg.num_heads, cfg.num_kv_heads
    attn = {
        "wq": ini.normal((n, d, h, hd), d ** -0.5,
                         L + ("embed", "q_heads", "head_dim")),
        "wk": ini.normal((n, d, kv, hd), d ** -0.5,
                         L + ("embed", "kv_heads", "head_dim")),
        "wv": ini.normal((n, d, kv, hd), d ** -0.5,
                         L + ("embed", "kv_heads", "head_dim")),
        "wo": ini.normal((n, h, hd, d), (h * hd) ** -0.5,
                         L + ("q_heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        attn["q_norm"] = ini.ones((n, hd), L + ("head_dim",))
        attn["k_norm"] = ini.ones((n, hd), L + ("head_dim",))
    return attn


def init_mlp(ini, n: int, d: int, f: int, gated: bool = True):
    """Stacked MLP leaves of ``n`` layers: SwiGLU, or a GELU MLP with biases
    (zeros) when not ``gated``."""
    if gated:
        return {"w_gate": ini.normal((n, d, f), d ** -0.5,
                                     L + ("embed", "mlp")),
                "w_up": ini.normal((n, d, f), d ** -0.5, L + ("embed", "mlp")),
                "w_down": ini.normal((n, f, d), f ** -0.5,
                                     L + ("mlp", "embed"))}
    return {"w_up": ini.normal((n, d, f), d ** -0.5, L + ("embed", "mlp")),
            "b_up": ini.zeros((n, f), L + ("mlp",)),
            "w_down": ini.normal((n, f, d), f ** -0.5, L + ("mlp", "embed")),
            "b_down": ini.zeros((n, d), L + ("embed",))}


def init_embedding(cfg: ModelConfig, ini):
    embedding = {"tok": ini.normal((cfg.vocab_size, cfg.d_model), 0.02,
                                   ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        embedding["unembed"] = ini.normal((cfg.d_model, cfg.vocab_size),
                                          cfg.d_model ** -0.5,
                                          ("embed", "vocab"))
    return embedding


def build(cfg: ModelConfig, ini):
    """The param tree, each leaf made by ``ini`` (``Drawers`` or
    ``AxisNames``): normal with std fan_in^-0.5 for projections, 0.02 for
    the token embedding, ones for norm scales, as the JAX initializer
    does."""
    d, n = cfg.d_model, cfg.num_layers
    p = {
        "embedding": init_embedding(cfg, ini),
        "layers": {
            "attn": init_attention(cfg, ini),
            "mlp": init_mlp(ini, n, d, cfg.d_ff),
            "ln1": ini.ones((n, d), L + ("embed",)),
            "ln2": ini.ones((n, d), L + ("embed",)),
        },
        "final_norm": ini.ones((d,), ("embed",)),
    }
    if cfg.num_patches:
        p["vision_proj"] = ini.normal((cfg.frontend_dim, d),
                                      cfg.frontend_dim ** -0.5,
                                      ("frontend", "embed"))
    return p


def init(cfg: ModelConfig, generator: torch.Generator | None, device="cuda"):
    """Random weights drawn from ``generator`` (which must live on
    ``device``); on the meta device, shapes and dtypes alone."""
    return build(cfg, drawers(cfg, generator, device))


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
    x = cm.act_shard(x, "batch", None, None)
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


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """``init_cache``'s tree on the meta device: shapes and dtypes alone."""
    return init_cache(cfg, batch, max_len, dtype, "meta")


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
    x = cm.act_shard(x, "batch", None, None)
    return prefill_layers(params, cfg, x, ffn, attention)


def prefill_layers(params, cfg: ModelConfig, x, ffn, attention=None,
                   lengths=None, positions=None):
    """The layer stack of a prefill from the embeddings x (B, T, d), with
    ``ffn(lp, cfg, h)`` as each layer's feed-forward. Returns what
    ``prefill`` returns.

    With ``lengths``, x (1, N, d) packs several prompts one after another,
    of those lengths (summing to N), and ``positions`` (N,) holds each
    token's position in its own prompt: every layer's norms, projections
    and feed-forward run once over all N rows, and each prompt attends only
    to itself through the flash-prefill op
    (``common.attention_prefill_packed``; ``attention`` is not used). The
    rotary tables are made in each layer, as the single-prompt pass makes
    them: held through the layers they would add to the peak of a long
    prompt's pass, which the MoE cell cannot spare. The logits are then each
    prompt's last token's, (P, V), and the cache holds the prompts' K/V
    packed as x is, (L, 1, N, KV, D).

    Each layer's K/V is copied into the stacked cache (allocated at the
    first layer) as soon as it is made and freed before the feed-forward
    runs: a long prompt's cache is held once, and no layer's piece stays
    inside a freed block of the feed-forward's larger temporaries, where it
    would keep the rest of that block from serving a later allocation."""
    packed = lengths is not None
    cache = None
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if packed:
            a, k, v = cm.attention_prefill_packed(lp["attn"], cfg, h, lengths,
                                                  positions)
        else:
            a, k, v = cm.attention_prefill(lp["attn"], cfg, h, attention)
        if cache is None:
            cache = {name: t.new_empty((cfg.num_layers,) + tuple(t.shape))
                     for name, t in (("k", k), ("v", v))}
        cache["k"][i] = k
        cache["v"][i] = v
        del k, v
        x = x + a
        h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp, cfg, h)
    if packed:
        ends = itertools.accumulate(lengths)
        x = torch.cat([x[:, e - 1:e] for e in ends], dim=1)   # (1, P, d)
        x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return cm.unembed(params["embedding"], x)[0], cache
    x = cm.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(params["embedding"], x)[:, 0]
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, ffn=ffn):
    """tokens: (B,) next input token; pos: (B,) int64, its absolute position.
    Updates the dense cache in place. Returns (logits (B, V), cache).
    ``ffn(lp, cfg, h)`` is each layer's feed-forward."""
    x = cm.embed(params["embedding"], tokens[:, None])
    x = cm.act_shard(x, "batch", None, None)
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
