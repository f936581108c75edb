"""The weights, made by the benchmark from the seed and handed to both the
program and the reference: one ``normal_`` call per stacked leaf, drawn in
bf16 on the device by a ``torch.Generator`` there, in the tree the program's
model API takes (per-layer leaves stacked on a leading layer axis; ``wq``
(L, d, H, D), ``wo`` (L, H, D, d), experts (L, E, d, f)). Scales are the
fan-in ones of the JAX initializer (std fan_in^-0.5, 0.02 for the token
table, 0.1 d^-0.5 for the router, ones for the norm scales).
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(cfg: dict, seed: int, device) -> dict:
    """The param tree of configuration file ``cfg`` from ``seed``."""
    dtype = DTYPES[cfg["torch_dtype"]]
    gen = torch.Generator(device).manual_seed(seed & (2**63 - 1))
    n, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])

    def normal(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=gen)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    attn = {"wq": normal((n, d, h, hd), d ** -0.5),
            "wk": normal((n, d, kv, hd), d ** -0.5),
            "wv": normal((n, d, kv, hd), d ** -0.5),
            "wo": normal((n, h, hd, d), (h * hd) ** -0.5)}
    if cfg.get("qk_norm"):
        attn["q_norm"] = ones((n, hd))
        attn["k_norm"] = ones((n, hd))
    layers = {"attn": attn, "ln1": ones((n, d)), "ln2": ones((n, d))}
    if cfg["family"] == "moe":
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        layers["moe"] = {"router": normal((n, d, e), 0.1 * d ** -0.5),
                         "w_gate": normal((n, e, d, f), d ** -0.5),
                         "w_up": normal((n, e, d, f), d ** -0.5),
                         "w_down": normal((n, e, f, d), f ** -0.5)}
    else:
        f = cfg["intermediate_size"]
        layers["mlp"] = {"w_gate": normal((n, d, f), d ** -0.5),
                         "w_up": normal((n, d, f), d ** -0.5),
                         "w_down": normal((n, f, d), f ** -0.5)}
    embedding = {"tok": normal((v, d), 0.02)}
    if not cfg.get("tie_word_embeddings"):
        embedding["unembed"] = normal((d, v), d ** -0.5)
    return {"embedding": embedding, "layers": layers,
            "final_norm": ones((d,))}
