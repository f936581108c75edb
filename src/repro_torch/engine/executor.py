"""Model executors behind the engine: the counterpart of
``repro/engine/executor.py``.

RealExecutor   — PyTorch compute against the paged pool (dense and moe
                 families) or slot-state caches (ssm and hybrid), on the
                 card by default; the CPU only when the caller asks.
SimExecutor    — no compute; the roofline cost model supplies step times and
                 the engine synthesises token ids.

Both return (prefill logits, decode logits, elapsed_seconds) so the engine
is agnostic; logits come back as numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import HardwareConfig, ModelConfig
from repro_torch.device import require as require_device
from repro_torch.engine import paged_model
from repro_torch.engine.costmodel import RooflineCost
from repro_torch.models import api


def _step_shape(prefills, decode):
    new_tokens = ctx = 0
    for pf in prefills or ():
        start, end = pf["chunk"]
        new_tokens += end - start
        ctx += end
    batch = total_ctx = 0
    if decode is not None:
        batch = len(decode["slots"])
        total_ctx = int(sum(p + 1 for p in decode["pos"]))
    return new_tokens, ctx, batch, total_ctx


class SimExecutor:
    """Analytic executor: timing only."""

    needs_logits = False

    def __init__(self, cfg: ModelConfig, hw: HardwareConfig, tp: int = 1,
                 efficiency: float = 0.45):
        self.cfg = cfg
        self.cost = RooflineCost(cfg, hw, tp=tp, efficiency=efficiency)

    def step(self, prefills: list, decode: Optional[dict]):
        """Mixed step. Returns (prefill_logits, decode_logits, elapsed)."""
        elapsed = self.cost.mixed_time(*_step_shape(prefills, decode))
        return ([None] * len(prefills or ()), None, elapsed)


class RealExecutor:
    """PyTorch executor: the paged pool for dense and moe, one slot-state
    cache slab over ``max_slots`` slots for ssm and hybrid.

    vlm and audio are refused, as they are in effect in the reference: its
    executor passes neither ``patch_embeds`` nor ``frames`` to prefill, so
    its prefill of either fails on the missing key; serving images or audio
    through the engine would be a feature the JAX package lacks.

    ``params`` is the model's tree of tensors on ``device``. The pool and
    the slab are f32, as in the JAX executor. A decode reads each slab leaf
    back in the dtype the model's own cache has at the params' dtype (the
    slab holds those values exactly, being written from them) and runs
    ``decode_fn`` on it, as the reference's ``decode_fn`` runs on its own
    caches. ``decode_steps`` and ``prefill_computes`` count the model passes
    this executor ran. With a ``tracer`` (``engine/steptrace.py``) each step
    records its ``executor.*`` spans.
    """

    needs_logits = True
    tracer = None

    def __init__(self, cfg: ModelConfig, params, num_blocks: int,
                 block_size: int, hw: HardwareConfig, tp: int = 1,
                 max_model_len: int = 4096, max_slots: int = 64,
                 device="cuda"):
        self.device = require_device(device)
        if cfg.family in ("vlm", "audio"):
            inputs = {"vlm": "patch embeddings", "audio": "audio frames"}
            raise NotImplementedError(
                f"RealExecutor: {cfg.family} is not served through the "
                f"engine: requests carry no {inputs[cfg.family]} (neither "
                f"does the reference's executor, whose {cfg.family} prefill "
                f"fails on the missing key)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        leaf = params["embedding"]["tok"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, executor on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.cost = RooflineCost(cfg, hw, tp=tp)
        self.paged = cfg.family in ("dense", "moe")
        if self.paged:
            self.pool = paged_model.init_pool(cfg, num_blocks, block_size,
                                              device=self.device)
            self.mb = -(-max_model_len // block_size)
        else:
            self.cache = api.init_cache(cfg, max_slots, max_model_len,
                                        dtype=torch.float32,
                                        device=self.device)
            self.cache_dtypes = {
                k: v.dtype for k, v in api.init_cache(
                    cfg, 1, 1, dtype=leaf.dtype, device="meta").items()}
        self.decode_steps = 0
        self.prefill_computes = 0

    # ------------------------------------------------------------------
    def step(self, prefills: list, decode: Optional[dict]):
        """Mixed step: decode batch first (pre-step KV state), then the
        prefill chunks. One combined cost-model time (weights stream once)."""
        tr = self.tracer
        if tr is not None:
            tr.open("executor.step", tr.now())
        elapsed = self.cost.mixed_time(*_step_shape(prefills, decode))
        dec_logits = self._decode(decode) if decode else None
        pre_logits = [self._prefill(pf) for pf in prefills or ()]
        if tr is not None:
            tr.close()
        return pre_logits, dec_logits, elapsed

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=self.device)

    def _prefill(self, pf: dict):
        if not pf["is_last"]:
            # chunked prefill: timing per chunk; compute happens once on the
            # final chunk (whole-prompt recompute — numerically identical)
            return None
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        toks = self._tensor(pf["token_ids"], np.int64)[None]
        table = (self._tensor(pf["block_table"], np.int64) if self.paged
                 else None)
        if tr is not None:
            t = tr.span("executor.prepare", t, kind="prefill")
        logits, cache = api.prefill_fn(self.params, self.cfg,
                                       {"tokens": toks})
        if self.paged:
            paged_model.write_prefill(self.pool, cache, table,
                                      self.block_size)
        else:
            cache = api.pad_cache(self.cfg, cache, self.max_model_len)
            for key, slab in self.cache.items():
                slab[:, pf["slot"]] = cache[key][:, 0]
        self.prefill_computes += 1
        if tr is not None:
            t = tr.span("executor.launch", t, kind="prefill")
        out = logits[0].float().cpu().numpy()
        if tr is not None:
            tr.span("executor.to_host", t, kind="prefill")
        return out

    def _decode(self, dec: dict):
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        toks = self._tensor(dec["tokens"], np.int64)
        pos = self._tensor(dec["pos"], np.int64)
        if self.paged:
            bt = np.zeros((len(dec["slots"]), self.mb), np.int32)
            for i, table in enumerate(dec["block_tables"]):
                bt[i, :len(table)] = table
            index = self._tensor(bt, np.int32)
        else:
            index = self._tensor(dec["slots"], np.int64)
        if tr is not None:
            t = tr.span("executor.prepare", t, kind="decode")
        if self.paged:
            logits, _ = paged_model.decode_step(
                self.params, self.cfg, toks, pos, self.pool, index)
        else:
            # gather the slots' caches, run decode_fn, scatter them back
            cache = {k: slab.index_select(1, index).to(self.cache_dtypes[k])
                     for k, slab in self.cache.items()}
            logits, cache = api.decode_fn(self.params, self.cfg, toks, cache,
                                          pos)
            for key, slab in self.cache.items():
                slab.index_copy_(1, index, cache[key].to(slab.dtype))
        self.decode_steps += 1
        if tr is not None:
            t = tr.span("executor.launch", t, kind="decode")
        out = logits.float().cpu().numpy()
        if tr is not None:
            tr.span("executor.to_host", t, kind="decode")
        return out
