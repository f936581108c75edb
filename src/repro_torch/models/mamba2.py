"""Mamba-2 (SSD, state-space duality) decoder stack in PyTorch, attention
free: the serving counterpart of ``repro/models/mamba2.py``.

Prefill runs the chunked SSD algorithm (intra-chunk products plus a
recurrence over chunk states); decode carries a fixed (B, H, P, S) state and
the causal conv's last inputs per layer. Both scans are plain PyTorch, as
they were plain jnp outside any Pallas kernel in the reference. Decode
updates the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import require as require_device
from repro_torch.models import common as cm
from repro_torch.models import griffin
from repro_torch.models import transformer as tfm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_n_groups, cfg.ssm_state_size


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights drawn from ``generator`` (on ``device``) with the JAX
    fan-in scales, each leaf in its dtype."""
    normal, ones, zeros = tfm.drawers(generator, tfm._DTYPES[cfg.param_dtype],
                                      require_device(device))
    n, d, k = cfg.num_layers, cfg.d_model, cfg.conv_kernel
    d_in, nheads, g, s = _dims(cfg)
    conv_dim = d_in + 2 * g * s
    return {
        "embedding": tfm.init_embedding(cfg, normal),
        "layers": {
            "in_proj": normal((n, d, 2 * d_in + 2 * g * s + nheads),
                              d ** -0.5),
            "conv_w": normal((n, k, conv_dim), k ** -0.5),
            "conv_b": zeros((n, conv_dim)),
            "A_log": griffin.linspace(zeros((n, nheads)), 0.0, 2.0),
            "D": ones((n, nheads)),
            "dt_bias": griffin.linspace(zeros((n, nheads)), -4.6, 0.0),
            "norm": ones((n, d_in)),
            "out_proj": normal((n, d_in, d), d_in ** -0.5),
            "ln": ones((n, d)),
        },
        "final_norm": ones((d,)),
    }


# --------------------------------------------------------------------------
# chunked SSD (prefill)
# --------------------------------------------------------------------------

def _segsum(x):
    """x: (..., c) -> (..., c, c) lower-triangular pairwise sums
    L[i, j] = sum_{j<k<=i} x[k] (-inf above the diagonal)."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked state-space-dual scan.

    x: (b, t, h, p)  dt: (b, t, h)  A: (h,) < 0  B, C: (b, t, g, s), h % g
    == 0. Returns (y (b, t, h, p) f32, final_state (b, h, p, s) f32). Raises
    ValueError where the reference asserts: t not a multiple of
    min(chunk, t).
    """
    b, t, h, p = x.shape
    g, s = B.shape[2], B.shape[3]
    rep = h // g
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"mamba2: sequence of {t} tokens is not a multiple "
                         f"of the SSD chunk {c}")
    nc = t // c
    f32 = torch.float32

    xr = x.reshape(b, nc, c, h, p)
    dtr = dt.reshape(b, nc, c, h).to(f32)
    Br = B.reshape(b, nc, c, g, s).repeat_interleave(rep, dim=3).to(f32)
    Cr = C.reshape(b, nc, c, g, s).repeat_interleave(rep, dim=3).to(f32)

    dA = dtr * A.to(f32)                              # (b, nc, c, h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.movedim(3, 2)))          # (b, nc, h, c, c)
    dtx = xr.to(f32) * dtr[..., None]                 # (b, nc, c, h, p)
    scores = torch.einsum("bzchs,bzlhs->bzhcl", Cr, Br) * L
    y_diag = torch.einsum("bzhcl,bzlhp->bzchp", scores, dtx)

    # 2. chunk states
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (b, nc, c, h)
    states = torch.einsum("bzlhs,bzlhp->bzhps", Br, dtx * decay[..., None])

    # 3. inter-chunk recurrence over the chunk boundaries
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])       # (b, nc, h)
    carry = (torch.zeros(b, h, p, s, dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for z in range(nc):
        prev.append(carry)                            # state BEFORE chunk z
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)            # (b, nc, h, p, s)

    # 4. inter-chunk (off-diagonal) output
    state_decay = torch.exp(dA_cs)                    # (b, nc, c, h)
    y_off = torch.einsum("bzchs,bzhps->bzchp", Cr, prev_states) \
        * state_decay[..., None]

    return (y_diag + y_off).reshape(b, t, h, p), carry


def ssd_step(x, dt, A, B, C, state):
    """Single-token recurrence. x (b, h, p), dt (b, h), B, C (b, g, s),
    state (b, h, p, s) -> (y (b, h, p), new_state), both f32."""
    f32 = torch.float32
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).to(f32)      # (b, h, s)
    Ch = C.repeat_interleave(rep, dim=1).to(f32)
    dt = dt.to(f32)
    dA = torch.exp(dt * A.to(f32))                    # (b, h)
    new = state * dA[..., None, None] \
        + (dt[..., None] * x.to(f32))[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhps,bhs->bhp", new, Ch)
    return y, new


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _split_proj(cfg, zxbcdt):
    d_in, nheads, g, s = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * g * s, nheads], dim=-1)


def _split_xbc(cfg, xBC):
    d_in, nheads, g, s = _dims(cfg)
    return torch.split(xBC, [d_in, g * s, g * s], dim=-1)


def _gated_out(lp, cfg, x, y, xs, z):
    """y + D * xs, gated by silu(z), normed, projected, added to x."""
    y = y.to(x.dtype) + lp["D"].to(x.dtype)[:, None] * xs
    y = y.reshape(*x.shape[:-1], -1)
    y = cm.rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    return x + y @ lp["out_proj"]


def _layer_prefill(lp, cfg: ModelConfig, x):
    """x (B, T, d) -> (out, ssm_state (B, H, P, S) f32, conv_state
    (B, k-1, conv_dim): the conv's last raw inputs)."""
    b, t, d = x.shape
    d_in, nheads, g, s = _dims(cfg)
    h = cm.rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xBC_raw, dt = _split_proj(cfg, h @ lp["in_proj"])
    xBC = F.silu(griffin.causal_conv(xBC_raw, lp["conv_w"], lp["conv_b"]))
    xs, B, C = _split_xbc(cfg, xBC)
    xs = xs.reshape(b, t, nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, state = ssd_chunked(xs, dt, A, B.reshape(b, t, g, s),
                           C.reshape(b, t, g, s), cfg.ssm_chunk)
    out = _gated_out(lp, cfg, x, y, xs, z)
    return out, state, griffin.conv_state(xBC_raw, cfg.conv_kernel)


def _layer_step(lp, cfg: ModelConfig, x, ssm_state, conv_state):
    """x: (B, d) one token -> (out, ssm_state, conv_state)."""
    b, d = x.shape
    d_in, nheads, g, s = _dims(cfg)
    h = cm.rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xBC, dt = _split_proj(cfg, h @ lp["in_proj"])
    xBC, conv_state = griffin.causal_conv_step(xBC, conv_state, lp["conv_w"],
                                               lp["conv_b"])
    xs, B, C = _split_xbc(cfg, F.silu(xBC))
    xs = xs.reshape(b, nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, ssm_state = ssd_step(xs, dt, A, B.reshape(b, g, s),
                            C.reshape(b, g, s), ssm_state)
    return _gated_out(lp, cfg, x, y, xs, z), ssm_state, conv_state


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Fixed size: ``max_len`` is not used. The SSM state is f32."""
    del max_len
    device = require_device(device)
    d_in, nheads, g, s = _dims(cfg)
    conv_dim = d_in + 2 * g * s
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, nheads, cfg.ssm_head_dim,
                            s), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.num_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=dtype, device=device),
    }


def prefill(params, cfg: ModelConfig, tokens):
    """Full prefill over tokens (B, T), T below the SSD chunk or a multiple
    of it. Returns (last-token logits (B, V), cache {"ssm", "conv"})."""
    x = cm.embed(params["embedding"], tokens)
    ssm, conv = [], []
    for i in range(cfg.num_layers):
        x, st, cst = _layer_prefill(tfm.layer(params["layers"], i), cfg, x)
        ssm.append(st)
        conv.append(cst)
    x = cm.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = cm.unembed(params["embedding"], x)[:, 0]
    return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos):
    """tokens: (B,); ``pos`` is not used (the recurrence is position free).
    Updates the cache in place. Returns (logits (B, V), cache)."""
    del pos
    x = cm.embed(params["embedding"], tokens)
    for i in range(cfg.num_layers):
        x, st, cst = _layer_step(tfm.layer(params["layers"], i), cfg, x,
                                 cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i] = st
        cache["conv"][i] = cst
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x), cache
