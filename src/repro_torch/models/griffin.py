"""Griffin / RecurrentGemma hybrid in PyTorch: the counterpart of
``repro/models/griffin.py``. RG-LRU recurrent blocks and local MQA attention
in the pattern (rec, rec, attn), kept as the JAX tree keeps them: ``groups``
of the three, stacked, plus a ``tail`` of rec layers (recurrentgemma-9b's 38
layers are 12 groups and 2 tail layers).

The RG-LRU's associative scan (``lax.associative_scan`` in the reference) is
a log-depth doubling scan in plain PyTorch with the reference's combine; it
ran outside any Pallas kernel there too. The attention block's prefill goes
through the flash-prefill op with the window; its decode keeps a rolling
buffer of ``attn_window`` slots. Decode updates the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

C_GATE = 8.0  # Griffin's fixed gate sharpness


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def linspace(leaf, lo: float, hi: float):
    """Fills ``leaf`` (n, width) with n copies of the JAX initializer's
    linspace row: ``width`` values from lo to hi, made in f32 and cast."""
    row = torch.linspace(lo, hi, leaf.shape[-1], dtype=torch.float32,
                         device=leaf.device)
    return leaf.copy_(row.to(leaf.dtype).expand_as(leaf))


def init_rec(cfg: ModelConfig, n: int, normal, ones, zeros):
    """Stacked leaves of ``n`` rec layers."""
    d, w, k = cfg.d_model, cfg.rnn_width, cfg.conv_kernel
    h = cfg.num_heads
    bs = w // h
    return {
        "w_gate_branch": normal((n, d, w), d ** -0.5),
        "w_in": normal((n, d, w), d ** -0.5),
        "w_out": normal((n, w, d), w ** -0.5),
        "conv_w": normal((n, k, w), k ** -0.5),
        "conv_b": zeros((n, w)),
        "gate_x": normal((n, h, bs, bs), bs ** -0.5),
        "gate_a": normal((n, h, bs, bs), bs ** -0.5),
        "bias_x": zeros((n, w)),
        "bias_a": zeros((n, w)),
        # so that a = sigmoid(lam)^c spans roughly (0.9, 0.999)
        "lam": linspace(zeros((n, w)), 0.7, 2.5),
        "mlp": tfm.init_mlp(normal, zeros, n, d, cfg.d_ff),
        "ln1": ones((n, d)),
        "ln2": ones((n, d)),
    }


def group_counts(cfg: ModelConfig):
    """num_layers -> (full (rec, rec, attn) groups, tail rec layers)."""
    pat = len(cfg.block_pattern) or 3
    return cfg.num_layers // pat, cfg.num_layers % pat


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights drawn from ``generator`` (on ``device``) with the JAX
    fan-in scales, each leaf in its dtype."""
    normal, ones, zeros = tfm.drawers(generator, tfm._DTYPES[cfg.param_dtype],
                                      require_device(device))
    n_groups, n_tail = group_counts(cfg)
    d = cfg.d_model
    p = {
        "embedding": tfm.init_embedding(cfg, normal),
        "groups": {
            "rec1": init_rec(cfg, n_groups, normal, ones, zeros),
            "rec2": init_rec(cfg, n_groups, normal, ones, zeros),
            "attn": {"attn": tfm.init_attention(cfg, normal, ones,
                                                n=n_groups),
                     "mlp": tfm.init_mlp(normal, zeros, n_groups, d,
                                         cfg.d_ff),
                     "ln1": ones((n_groups, d)),
                     "ln2": ones((n_groups, d))},
        },
        "final_norm": ones((d,)),
    }
    if n_tail:
        p["tail"] = init_rec(cfg, n_tail, normal, ones, zeros)
    return p


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def _block_diag(u, w):
    """u: (..., W), w: (H, bs, bs) block-diagonal product."""
    h, bs, _ = w.shape
    shape = u.shape
    u = u.reshape(*shape[:-1], h, bs)
    return torch.einsum("...hi,hij->...hj", u, w).reshape(shape)


def _rg_lru_gates(p, u):
    """u: (..., W) -> (log_a, gated_input), both f32."""
    i_g = torch.sigmoid(_block_diag(u, p["gate_x"]) + p["bias_x"])
    r_g = torch.sigmoid(_block_diag(u, p["gate_a"]) + p["bias_a"])
    log_a = (-C_GATE * F.softplus(p["lam"].float())
             * r_g.float())                                   # (..., W) <= 0
    a2 = torch.exp(2.0 * log_a)
    x_in = (i_g * u).float() * torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    return log_a, x_in


def linear_scan(log_a, x):
    """h_t = exp(log_a_t) * h_{t-1} + x_t over dim 1, from h_{-1} = 0.

    The reference's associative scan with its combine
    (a1, b1), (a2, b2) -> (a1 + a2, b1 * exp(a2) + b2), computed by doubling:
    log2(T) steps, each combining every position with the one ``off``
    before it."""
    a, b = log_a, x
    t, off = a.shape[1], 1
    while off < t:
        b = torch.cat([b[:, :off], b[:, :-off] * torch.exp(a[:, off:])
                       + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] + a[:, off:]], dim=1)
        off *= 2
    return b


def rg_lru_scan(p, u):
    """u (B, T, W) -> h (B, T, W) in u's dtype."""
    log_a, x_in = _rg_lru_gates(p, u)
    return linear_scan(log_a, x_in).to(u.dtype)


def rg_lru_step(p, u, h_prev):
    """Decode: u (B, W), h_prev (B, W) f32 -> (h_out in u's dtype, h_new)."""
    log_a, x_in = _rg_lru_gates(p, u)
    h_new = torch.exp(log_a) * h_prev + x_in
    return h_new.to(u.dtype), h_new


def causal_conv(x, w, b):
    """Depthwise causal conv. x (B, T, W), w (k, W) -> (B, T, W); shift i
    takes tap k-1-i."""
    k = w.shape[0]
    out = torch.zeros_like(x) + b
    for i in range(k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + w[k - 1 - i] * shifted
    return out


def causal_conv_step(x, conv_state, w, b):
    """x (B, W), conv_state (B, k-1, W), the last k-1 inputs -> (y (B, W),
    new_state). An f32 state makes the step f32, as in JAX."""
    window = torch.cat(cm.promoted(conv_state, x[:, None]), dim=1)  # (B,k,W)
    y = torch.einsum("bkw,kw->bw", *cm.promoted(window, w)) + b
    return y, window[:, 1:]


def conv_state(x, k: int):
    """The last k-1 inputs of x (B, T, W), zero-padded in front."""
    return F.pad(x, (0, 0, k - 1, 0))[:, -(k - 1):]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _rec_block_train(p, cfg: ModelConfig, x):
    return _rec_block_prefill(p, cfg, x)[0]


def _attn_block_train(p, cfg: ModelConfig, x, positions):
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + cm.attention_train(p["attn"], cfg, h, window=cfg.attn_window,
                               positions=positions)
    h = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + cm.mlp(p["mlp"], h)


def _rec_block_prefill(p, cfg: ModelConfig, x):
    """Returns (out, final h_state (B, W) f32, conv_state (B, k-1, W))."""
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    gate = _gelu(h @ p["w_gate_branch"])
    conv_in = h @ p["w_in"]
    u = causal_conv(conv_in, p["conv_w"], p["conv_b"])
    log_a, x_in = _rg_lru_gates(p, u)
    hs = linear_scan(log_a, x_in)
    x = x + (gate * hs.to(u.dtype)) @ p["w_out"]
    h2 = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    out = x + cm.mlp(p["mlp"], h2)
    return out, hs[:, -1], conv_state(conv_in, cfg.conv_kernel)


def _rec_block_step(p, cfg: ModelConfig, x, h_state, conv):
    """x: (B, d) one token -> (out, h_state, conv_state)."""
    h = cm.rms_norm(x, p["ln1"], cfg.norm_eps)
    gate = _gelu(h @ p["w_gate_branch"])
    u, conv = causal_conv_step(h @ p["w_in"], conv, p["conv_w"],
                               p["conv_b"])
    r, h_state = rg_lru_step(p, u, h_state)
    x = x + (gate * r) @ p["w_out"]
    h = cm.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + cm.mlp(p["mlp"], h), h_state, conv


# --------------------------------------------------------------------------
# forward (training) / serving
# --------------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, tokens, remat: bool = True):
    """tokens: (B, T) -> logits (B, T, V). The groups are recomputed in the
    backward pass under ``remat``; the tail layers are not, as in the
    reference."""
    x = cm.embed(params["embedding"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, gp):
        x = _rec_block_train(gp["rec1"], cfg, x)
        x = _rec_block_train(gp["rec2"], cfg, x)
        return _attn_block_train(gp["attn"], cfg, x, positions), None

    x, _ = cm.layer_scan(body, x, params["groups"], remat)
    if "tail" in params:
        x, _ = cm.layer_scan(lambda x, lp: (_rec_block_train(lp, cfg, x),
                                            None), x, params["tail"])
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Window-bounded: ``max_len`` is not used. The RG-LRU states are f32."""
    del max_len
    device = require_device(device)
    n_groups, n_tail = group_counts(cfg)
    w, k = cfg.rnn_width, cfg.conv_kernel
    kv = (batch, cfg.attn_window, cfg.num_kv_heads, cfg.head_dim)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = {"g_k": zeros((n_groups,) + kv), "g_v": zeros((n_groups,) + kv),
             "g_h": zeros((n_groups, batch, 2, w), torch.float32),
             "g_conv": zeros((n_groups, batch, 2, k - 1, w))}
    if n_tail:
        cache["t_h"] = zeros((n_tail, batch, w), torch.float32)
        cache["t_conv"] = zeros((n_tail, batch, k - 1, w))
    return cache


def prefill(params, cfg: ModelConfig, tokens, attention=None):
    """Full prefill over tokens (B, T). Returns (last-token logits (B, V),
    cache as ``init_cache`` lays it out, the KV in rolling-window layout).
    ``attention`` is passed to ``common.attention_prefill`` (default: the
    flash-prefill op)."""
    x = cm.embed(params["embedding"], tokens)
    n_groups, n_tail = group_counts(cfg)
    cache = {"g_k": [], "g_v": [], "g_h": [], "g_conv": []}
    for i in range(n_groups):
        gp = tfm.layer(params["groups"], i)
        x, h1, c1 = _rec_block_prefill(gp["rec1"], cfg, x)
        x, h2, c2 = _rec_block_prefill(gp["rec2"], cfg, x)
        ap = gp["attn"]
        h = cm.rms_norm(x, ap["ln1"], cfg.norm_eps)
        a, ck, cv = cm.attention_prefill(ap["attn"], cfg, h, attention,
                                         window=cfg.attn_window)
        x = x + a
        h = cm.rms_norm(x, ap["ln2"], cfg.norm_eps)
        x = x + cm.mlp(ap["mlp"], h)
        cache["g_k"].append(ck)
        cache["g_v"].append(cv)
        cache["g_h"].append(torch.stack([h1, h2], dim=1))
        cache["g_conv"].append(torch.stack([c1, c2], dim=1))
    if n_tail:
        cache.update(t_h=[], t_conv=[])
        for i in range(n_tail):
            x, h, c = _rec_block_prefill(tfm.layer(params["tail"], i), cfg, x)
            cache["t_h"].append(h)
            cache["t_conv"].append(c)
    x = cm.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(params["embedding"], x)[:, 0]
    return logits, {k: torch.stack(v) for k, v in cache.items()}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos):
    """tokens, pos: (B,). Updates the cache in place. Returns (logits (B, V),
    cache)."""
    x = cm.embed(params["embedding"], tokens)                  # (B, d)
    n_groups, n_tail = group_counts(cfg)
    for i in range(n_groups):
        gp = tfm.layer(params["groups"], i)
        hh, cc = cache["g_h"][i], cache["g_conv"][i]
        for j, name in enumerate(("rec1", "rec2")):
            x, h, c = _rec_block_step(gp[name], cfg, x, hh[:, j], cc[:, j])
            hh[:, j] = h
            cc[:, j] = c
        ap = gp["attn"]
        h = cm.rms_norm(x[:, None], ap["ln1"], cfg.norm_eps)
        a, _, _ = cm.attention_decode(ap["attn"], cfg, h, cache["g_k"][i],
                                      cache["g_v"][i], pos,
                                      window=cfg.attn_window)
        x = x + a[:, 0]
        h = cm.rms_norm(x, ap["ln2"], cfg.norm_eps)
        x = x + cm.mlp(ap["mlp"], h)
    for i in range(n_tail):
        x, h, c = _rec_block_step(tfm.layer(params["tail"], i), cfg, x,
                                  cache["t_h"][i], cache["t_conv"][i])
        cache["t_h"][i] = h
        cache["t_conv"][i] = c
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x), cache
