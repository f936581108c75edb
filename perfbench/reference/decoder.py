"""Plain PyTorch reference of the decoder-only models the benchmark serves
(dense: Mistral-Small-24B; moe: Qwen3-30B-A3B), in float32 with TF32 off.

It follows the published architecture: token embedding; per layer RMSNorm,
GQA attention with rotary positions (rotate-half), per-head RMSNorm of q and
k where the configuration has ``qk_norm``, causal softmax; RMSNorm and a
SwiGLU feed-forward, or for moe a softmax router whose top-k weights are
renormalised to sum to one over SwiGLU experts; a final RMSNorm and the
output head.

Every token of a prompt or a decode batch is routed to its own top-k
experts, none dropped, as the published model routes.

It imports nothing of the program and takes nothing the program made: the
weights are the benchmark's, the token ids the traffic's and the served
tokens the program's output under judgement. ``quantize`` rounds every
product's operands to float8 (e4m3; per row of activations, per output
column of weights): that is the control, the step below bfloat16.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3
Q_CHUNK = 512     # query rows of one attention block
ROW_CHUNK = 2048  # rows of one feed-forward block


def _fp8(x, dim):
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Products:
    """x @ w in float32, or with ``quantize`` on float8-rounded operands."""

    def __init__(self, quantize: bool):
        self.quantize = quantize

    def weight(self, w):
        """A (..., in, out) weight in float32, rounded per output column."""
        w = w.float()
        return _fp8(w, -2) if self.quantize else w

    def __call__(self, x, w):
        if self.quantize:
            x = _fp8(x, -1)
        return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, theta: float):
    """x (T, H, D) at positions 0..T-1; angles in float64."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA: q (T, H, D), k/v (T, KV, D) -> (T, H*D)."""
    t, h, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(t, kvh, h // kvh, d)
    out = torch.empty_like(q)
    for a in range(0, t, Q_CHUNK):
        b = min(t, a + Q_CHUNK)
        s = torch.einsum("tkqd,skd->kqts", qg[a:b], k[:b]) * d ** -0.5
        mask = (torch.arange(b, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        s = torch.where(mask, s, float("-inf")).softmax(-1)
        out[a:b] = torch.einsum("kqts,skd->tkqd", s, v[:b]).reshape(b - a, h, d)
    return out.reshape(t, h * d)


def _swiglu(mm, x, wg, wu, wd):
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


def _moe(mm, x, lw, cfg):
    """x (N, d) -> (N, d): each row routed to its top-k experts by a
    softmax router, the k weights renormalised, no row dropped."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = mm(x, lw["router"]).softmax(-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for ex in range(e):
        rows, slot = torch.nonzero(top_i == ex, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = _swiglu(mm, x[rows], lw["w_gate"][ex], lw["w_up"][ex],
                      lw["w_down"][ex])
        y.index_add_(0, rows, out * top_p[rows, slot][:, None])
    return y


def _layer_weights(params, i: int, mm, moe: bool):
    lp = params["layers"]
    a = lp["attn"]
    d = a["wq"].shape[1]
    w = {"wq": mm.weight(a["wq"][i].reshape(d, -1)),
         "wk": mm.weight(a["wk"][i].reshape(d, -1)),
         "wv": mm.weight(a["wv"][i].reshape(d, -1)),
         "wo": mm.weight(a["wo"][i].reshape(-1, d)),
         "ln1": lp["ln1"][i], "ln2": lp["ln2"][i]}
    if "q_norm" in a:
        w["q_norm"], w["k_norm"] = a["q_norm"][i], a["k_norm"][i]
    f = lp["moe"] if moe else lp["mlp"]
    for key in ("w_gate", "w_up", "w_down") + (("router",) if moe else ()):
        w[key] = mm.weight(f[key][i])
    return w


@torch.no_grad()
def logits_at(params, cfg: dict, seqs, quantize: bool = False):
    """For each (token ids, first, n) in ``seqs``: the float32 logits of
    positions first .. first + n - 1, each predicting the next token, over
    a causal pass of the whole sequence. Returns a list of (n, V)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _logits_at(params, cfg, seqs, _Products(quantize))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _logits_at(params, cfg, seqs, mm):
    moe = cfg["family"] == "moe"
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    emb = params["embedding"]
    dev = emb["tok"].device
    xs = [emb["tok"][torch.as_tensor(toks, device=dev)].float()
          for toks, _, _ in seqs]
    for i in range(cfg["num_hidden_layers"]):
        w = _layer_weights(params, i, mm, moe)
        for r, x in enumerate(xs):
            t = x.shape[0]
            hn = _rms(x, w["ln1"], eps)
            q = mm(hn, w["wq"]).reshape(t, h, hd)
            k = mm(hn, w["wk"]).reshape(t, kvh, hd)
            v = mm(hn, w["wv"]).reshape(t, kvh, hd)
            if "q_norm" in w:
                q, k = _rms(q, w["q_norm"], eps), _rms(k, w["k_norm"], eps)
            a = _attention(_rope(q, theta), _rope(k, theta), v)
            x += mm(a, w["wo"])
            if not moe:
                for c in range(0, t, ROW_CHUNK):
                    hn = _rms(x[c:c + ROW_CHUNK], w["ln2"], eps)
                    x[c:c + ROW_CHUNK] += _swiglu(mm, hn, w["w_gate"],
                                                  w["w_up"], w["w_down"])
        if moe:
            rows = torch.cat(xs)
            y = _moe(mm, _rms(rows, w["ln2"], eps), w, cfg)
            off = 0
            for x in xs:
                x += y[off:off + x.shape[0]]
                off += x.shape[0]
        del w
    head = emb.get("unembed")
    head = mm.weight(emb["tok"].T if head is None else head)
    out = []
    for x, (_, first, n) in zip(xs, seqs):
        out.append(mm(_rms(x[first:first + n], params["final_norm"], eps),
                      head))
    return out
