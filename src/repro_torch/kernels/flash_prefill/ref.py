"""Plain PyTorch causal (optionally windowed) prefill attention: a
line-for-line counterpart of the JAX oracle
(``repro/kernels/flash_prefill/ref.py``).

q, k, v : (B, T, H, D) / (B, T, KV, D); returns (B, T, H, D). Key j is
visible to query i iff j <= i and, when window > 0, j > i - window.
"""
from __future__ import annotations

import torch


def flash_prefill_ref(q, k, v, window: int = 0):
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qpk = h // kvh
    qg = q.reshape(b, t, kvh, qpk, d).float()
    kg = k.float()
    vg = v.float()
    logits = torch.einsum("btkqd,bskd->bkqts", qg, kg) * (d ** -0.5)
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkqts,bskd->btkqd", probs, vg)
    return out.reshape(b, t, h, d).to(q.dtype)
