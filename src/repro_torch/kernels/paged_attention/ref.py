"""Plain PyTorch paged decode attention: a line-for-line counterpart of the
JAX oracle (``repro/kernels/paged_attention/ref.py``).

Layouts:
  q            : (S, H, D)          one new token per sequence
  pool_k/v     : (NB, BS, KV, D)    global block pool
  block_tables : (S, MB) int32      logical page -> physical block
  context_lens : (S,)   int32       tokens valid per sequence (incl. new)

GQA: query head h reads kv head h // QPK.
"""
from __future__ import annotations

import torch


def paged_attention_ref(q, pool_k, pool_v, block_tables, context_lens):
    s, h, d = q.shape
    nb, bs, kv, _ = pool_k.shape
    mb = block_tables.shape[1]
    qpk = h // kv

    bt = block_tables.long()
    k = pool_k[bt].reshape(s, mb * bs, kv, d)        # (S, MB*BS, KV, D)
    v = pool_v[bt].reshape(s, mb * bs, kv, d)

    qg = q.reshape(s, kv, qpk, d).float()
    kg = k.movedim(2, 1).float()                     # (S, KV, MB*BS, D)
    vg = v.movedim(2, 1).float()

    logits = torch.einsum("skqd,sktd->skqt", qg, kg) * (d ** -0.5)
    valid = (torch.arange(mb * bs, device=q.device)[None, :]
             < context_lens[:, None])
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("skqt,sktd->skqd", probs, vg)
    return out.reshape(s, h, d).to(q.dtype)
