"""Mixture-of-Experts decoder transformer (qwen3-moe, kimi-k2) in PyTorch:
the counterpart of ``repro/models/moe.py``.

Routing sorts each token's top-k entries by expert id, as the reference
does. Training dispatches them as the reference's capacity dispatch: into an
(E, C, d) buffer, every expert one batched product over its C rows
(``torch.bmm``, plain products as XLA's were in the reference), an expert
past C entries dropping the excess, exactly as the reference does. Serving
is dropless: every token reaches all k of its experts at every batch size.
On a CUDA device the sorted rows go through the hand-written grouped expert
GEMM (``kernels/moe_grouped``), which computes each expert over its own rows
only; elsewhere through the same buffer with C = n, which no expert can
overflow.

Attention is the dense transformer's; only each layer's feed-forward
differs. The layer loops are ``transformer``'s, with this module's ``ffn``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.moe_grouped import ops as grouped
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

CAPACITY_FACTOR = 1.25


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def build(cfg: ModelConfig, ini):
    """The param tree, each leaf made by ``ini`` (``transformer.Drawers`` or
    ``AxisNames``) with the JAX fan-in scales: router 0.1 * d^-0.5, experts
    d^-0.5 and f^-0.5 for ``w_down``, a shared SwiGLU of width moe_d_ff *
    num_shared_experts. Each leaf is drawn directly in its dtype: at full
    width one expert leaf alone is tens of GB."""
    n, d = cfg.num_layers, cfg.d_model
    e, f = cfg.num_experts, cfg.moe_d_ff
    L = tfm.L
    moe = {
        "router": ini.normal((n, d, e), 0.1 * d ** -0.5,
                             L + ("embed", "expert")),
        "w_gate": ini.normal((n, e, d, f), d ** -0.5,
                             L + ("expert", "embed", "mlp")),
        "w_up": ini.normal((n, e, d, f), d ** -0.5,
                           L + ("expert", "embed", "mlp")),
        "w_down": ini.normal((n, e, f, d), f ** -0.5,
                             L + ("expert", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        moe["shared"] = tfm.init_mlp(ini, n, d, f * cfg.num_shared_experts)
    return {
        "embedding": tfm.init_embedding(cfg, ini),
        "layers": {"attn": tfm.init_attention(cfg, ini), "moe": moe,
                   "ln1": ini.ones((n, d), L + ("embed",)),
                   "ln2": ini.ones((n, d), L + ("embed",))},
        "final_norm": ini.ones((d,), ("embed",)),
    }


def init(cfg: ModelConfig, generator: torch.Generator | None, device="cuda"):
    """Random weights drawn from ``generator`` (on ``device``); on the meta
    device, shapes and dtypes alone."""
    return build(cfg, tfm.drawers(cfg, generator, device))


# --------------------------------------------------------------------------
# routing + dispatch
# --------------------------------------------------------------------------

def capacity(n: int, k: int, e: int, capacity_factor) -> int:
    """Rows per expert for n tokens. Serving (None): n, which is dropless at
    every n, since a token's k experts are distinct (the reference's own
    setting for it is capacity_factor = e / k). Otherwise GShard's
    n*k*cf/e, past which an expert drops entries."""
    if capacity_factor is None:
        return n
    return int(max(1, (n * k * capacity_factor) // e))


def top_k(probs, k: int):
    """The k largest values per row and their indices, ties to the lower
    index as ``lax.top_k`` breaks them (``torch.topk`` promises no order for
    equal values): a stable descending sort, then its first k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p, cfg: ModelConfig, x, capacity_factor=CAPACITY_FACTOR,
              aux_loss: bool = True):
    """x: (B, T, d) -> (y, aux_loss), as the reference's ``moe_block``.

    capacity_factor=None is serving mode: dropless (see ``capacity``), on a
    CUDA device through the grouped kernel. Every shape depends on n = B*T
    alone and nothing is read back to the host, so the layer never stalls
    it. The output is the same on every run: no two entries are summed into
    one row of the dispatch, and each token's k expert outputs are added one
    after another in ascending expert id, in x's dtype, the order in which
    the reference's scatter-add meets them. The kernel writes its output
    over its sorted input rows and the k outputs are gathered one at a
    time, so a long prompt's layer holds one (N*k, d) buffer of routed rows
    at a time, not three. ``aux_loss=False`` skips the load-balancing loss
    (returned as None), which serving drops: its nine launches a layer are
    host time on every step of an eager decode.
    """
    b, t, d = x.shape
    n = b * t
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    xf = x.reshape(n, d)

    logits = (xf @ p["router"]).float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                            # (N, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)               # renormalise

    flat_e = cm.whole(top_i.reshape(-1))                      # (N*k,)
    aux = _aux_loss(cfg, probs, flat_e) if aux_loss else None
    flat_w = cm.whole(top_p.reshape(-1).to(x.dtype))

    se, order = torch.sort(flat_e, stable=True)
    sw = flat_w[order]
    stok = order // k                       # entry i is token i // k's
    # where each expert's run starts in the sorted entries (the last: N*k)
    edges = torch.arange(e + 1, device=dev)
    if capacity_factor is None and dev.type == "cuda":
        rows = xf.index_select(0, stok)
        gathered = grouped.moe_grouped(
            rows, torch.searchsorted(se, edges, out_int32=True),
            p["w_gate"], p["w_up"], p["w_down"], out=rows)
        gathered.mul_(sw[:, None])                            # sorted order
    else:
        start = torch.searchsorted(se, edges)
        gathered = _dispatch(p, xf, se, sw, stok, start[:e],
                             capacity(n, k, e, capacity_factor))
    # each token's k entries, by their sorted position: ascending expert id
    where = torch.empty_like(order)
    where[order] = torch.arange(n * k, device=dev)
    at = where.reshape(n, k).sort(dim=-1).values              # (N, k)
    y = gathered[at[:, 0]]
    for j in range(1, k):
        y = y + gathered[at[:, j]]

    y = cm.alike(y, x)
    if "shared" in p:
        y = y + cm.mlp(p["shared"], xf)
    return y.reshape(b, t, d), aux


def _aux_loss(cfg: ModelConfig, probs, flat_e):
    """The Switch-style load-balancing loss of one layer's routing; the
    counts are exact in f32."""
    e = cfg.num_experts
    nk = flat_e.shape[0]
    counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
    counts.index_add_(0, flat_e, torch.ones(nk, dtype=torch.float32,
                                            device=probs.device))
    return e * torch.sum(counts / nk * probs.mean(0)) \
        * cfg.router_aux_loss_coef


def _dispatch(p, xf, se, sw, stok, start, cap: int):
    """The sorted entries through an (E, cap, d) buffer and one batched
    product per weight: each entry's weighted expert output in sorted order,
    zero for an entry past its expert's ``cap`` (dropped)."""
    e, d = p["w_gate"].shape[0], xf.shape[1]
    pos = torch.arange(se.shape[0], device=xf.device) - start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)         # overflow row

    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    # only dropped entries share a row: the last. index_select, not
    # indexing: its backward sums a token's k copies in a fixed order
    buf[slot] = cm.whole(xf).index_select(0, stok)
    buf = buf[:-1].reshape(e, cap, d)
    buf = cm.act_shard(buf, "expert", None, None)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"])                           # (E, C, d)
    out = cm.act_shard(out, "expert", None, None)

    out_flat = cm.whole(out.reshape(e * cap, d))
    return torch.where(keep[:, None],
                       out_flat.index_select(0, slot.clamp(max=e * cap - 1)),
                       0.0) * sw[:, None]


# --------------------------------------------------------------------------
# forward (training) / serving
# --------------------------------------------------------------------------

def _block(lp, cfg: ModelConfig, x, positions,
           capacity_factor=CAPACITY_FACTOR):
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + cm.attention_train(lp["attn"], cfg, h, positions=positions)
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_block(lp["moe"], cfg, h, capacity_factor)
    return x + y, aux


def forward_train(params, cfg: ModelConfig, tokens, remat: bool = True,
                  capacity_factor=CAPACITY_FACTOR):
    """tokens: (B, T) -> (logits (B, T, V), aux loss summed over layers).
    Training routes with GShard's capacity, so an expert past it drops
    entries."""
    x = cm.embed(params["embedding"], tokens)
    x = cm.act_shard(x, "batch", None, None)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, lp):
        return _block(lp, cfg, x, positions, capacity_factor)

    x, auxes = cm.layer_scan(body, x, params["layers"], remat)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(params["embedding"], x), torch.stack(auxes).sum()


def ffn(lp, cfg: ModelConfig, h):
    """One layer's feed-forward when serving: ``moe_block`` in serving
    mode (dropless; on the card the grouped kernel), with no aux loss."""
    y, _ = moe_block(lp["moe"], cfg, h, capacity_factor=None,
                     aux_loss=False)
    return y


init_cache = tfm.init_cache
cache_specs = tfm.cache_specs


def prefill(params, cfg: ModelConfig, tokens, attention=None):
    """As ``transformer.prefill``, each layer's feed-forward the MoE block."""
    x = cm.embed(params["embedding"], tokens)
    x = cm.act_shard(x, "batch", None, None)
    return tfm.prefill_layers(params, cfg, x, ffn, attention)


def decode_step(params, cfg: ModelConfig, tokens, cache, pos):
    """As ``transformer.decode_step`` (dense cache, in place), each layer's
    feed-forward the MoE block."""
    return tfm.decode_step(params, cfg, tokens, cache, pos, ffn=ffn)
