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


def pack_prefills(prefills: list, budget: int) -> list:
    """The prefill passes of a step: for each pass, the indices into
    ``prefills`` (the executor's input) of the prompts it computes. Only
    prompts on their last chunk are computed, each whole; they are taken in
    the scheduler's order and cut into runs whose prompt tokens together
    stay within ``budget``. A prompt longer than that is a pass alone."""
    passes, used = [], budget
    for i, pf in enumerate(prefills):
        if not pf["is_last"]:
            continue
        n = len(pf["token_ids"])
        if used + n > budget:
            passes.append([])
            used = 0
        passes[-1].append(i)
        used += n
    return passes


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
    caches. ``decode_steps`` counts the decode passes this executor ran,
    ``prefill_computes`` the prompts it computed and ``prefill_passes`` the
    prefill passes that computed them. For moe, ``moe_calls`` counts the
    MoE layers those passes ran (layers x passes) and ``moe_rows`` the rows
    they routed (n x k a layer for a pass of n tokens). With a ``tracer``
    (``engine/steptrace.py``) each step records its ``executor.*`` spans,
    a prefill's ``executor.launch`` with the ``prompts`` its pass computed.

    A dense or moe model computes a step's prompts on their last chunk
    together (``pack_prefills``): in passes of at most
    ``max_prefill_tokens`` prompt tokens, the engine's budget a step, each
    through ``paged_model.prefill`` (one staged copy to the device, one
    pass of every layer over all the pass's rows, one scatter of its K/V a
    group of layers, one copy of its logits to the host), so a pass's
    activations are never larger than a single prompt's of that budget; a
    longer prompt is a pass alone. The slot-state families compute one
    prompt a pass. The JAX package has no counterpart: its executor
    prefills one prompt a call.

    A dense or moe model decodes through ``paged_model.PagedDecoder``: each
    batch padded to a bucket of ``decode_buckets(max_slots)``, replayed
    from CUDA graphs captured here on the card and run eagerly on the CPU;
    the slot-state families decode eagerly. ``graph_decodes`` counts the
    replayed decodes and ``graph_padding_rows`` the padding rows they ran
    (the bucket less the batch, each replay). The pool has one page more
    than the allocator's ``num_blocks``, at index ``num_blocks``, which
    only the padding rows touch.
    """

    needs_logits = True
    tracer = None

    def __init__(self, cfg: ModelConfig, params, num_blocks: int,
                 block_size: int, hw: HardwareConfig, tp: int = 1,
                 max_model_len: int = 4096, max_slots: int = 64,
                 device="cuda", max_prefill_tokens: int = 2048):
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
        self.max_prefill_tokens = max_prefill_tokens
        self.cost = RooflineCost(cfg, hw, tp=tp)
        self.paged = cfg.family in ("dense", "moe")
        if self.paged:
            self.pool = paged_model.init_pool(cfg, num_blocks + 1, block_size,
                                              device=self.device)
            self.decoder = paged_model.PagedDecoder(
                params, cfg, self.pool, max_slots,
                -(-max_model_len // block_size), scratch=num_blocks)
        else:
            self.cache = api.init_cache(cfg, max_slots, max_model_len,
                                        dtype=torch.float32,
                                        device=self.device)
            self.cache_dtypes = {
                k: v.dtype for k, v in api.init_cache(
                    cfg, 1, 1, dtype=leaf.dtype, device="meta").items()}
        self.decode_steps = 0
        self.graph_decodes = 0
        self.graph_padding_rows = 0
        self.prefill_computes = 0
        self.prefill_passes = 0
        self.moe_calls = 0
        self.moe_rows = 0

    # ------------------------------------------------------------------
    def step(self, prefills: list, decode: Optional[dict]):
        """Mixed step: decode batch first (pre-step KV state), then the
        prefill chunks. One combined cost-model time (weights stream once)."""
        tr = self.tracer
        if tr is not None:
            tr.open("executor.step", tr.now())
        elapsed = self.cost.mixed_time(*_step_shape(prefills, decode))
        dec_logits = self._decode(decode) if decode else None
        prefills = prefills or []
        # chunked prefill: timing per chunk; compute happens once on the
        # final chunk (whole-prompt recompute — numerically identical)
        pre_logits = [None] * len(prefills)
        if self.paged:
            for group in pack_prefills(prefills, self.max_prefill_tokens):
                rows = self._prefill_pass([prefills[i] for i in group])
                for i, row in zip(group, rows):
                    pre_logits[i] = row
        else:
            for i, pf in enumerate(prefills):
                if pf["is_last"]:
                    pre_logits[i] = self._prefill(pf)
        if tr is not None:
            tr.close()
        return pre_logits, dec_logits, elapsed

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=self.device)

    def _count_moe(self, n: int):
        """Counts a pass of ``n`` tokens through a moe model's layers."""
        if self.cfg.family == "moe":
            self.moe_calls += self.cfg.num_layers
            self.moe_rows += (self.cfg.num_layers * n
                              * self.cfg.num_experts_per_tok)

    def _prefill_pass(self, pfs: list):
        """One packed pass over the whole prompts ``pfs`` (dense, moe);
        returns their last tokens' logits, (P, V)."""
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        lengths = [len(pf["token_ids"]) for pf in pfs]
        staged = self._tensor(paged_model.stage_prefill(
            pfs, self.block_size, self.decoder.scratch), np.int64)
        if tr is not None:
            t = tr.span("executor.prepare", t, kind="prefill")
        logits = paged_model.prefill(self.params, self.cfg, self.pool, staged,
                                     lengths)
        self.prefill_computes += len(pfs)
        self.prefill_passes += 1
        self._count_moe(sum(lengths))
        if tr is not None:
            t = tr.span("executor.launch", t, kind="prefill",
                        prompts=len(pfs))
        out = logits.float().cpu().numpy()
        if tr is not None:
            tr.span("executor.to_host", t, kind="prefill")
        return out

    def _prefill(self, pf: dict):
        """One whole prompt of a slot-state model (ssm, hybrid) into its
        slot; returns its last token's logits."""
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        toks = self._tensor(pf["token_ids"], np.int64)[None]
        if tr is not None:
            t = tr.span("executor.prepare", t, kind="prefill")
        logits, cache = api.prefill_fn(self.params, self.cfg,
                                       {"tokens": toks})
        cache = api.pad_cache(self.cfg, cache, self.max_model_len)
        for key, slab in self.cache.items():
            slab[:, pf["slot"]] = cache[key][:, 0]
        self.prefill_computes += 1
        self.prefill_passes += 1
        if tr is not None:
            t = tr.span("executor.launch", t, kind="prefill", prompts=1)
        out = logits[0].float().cpu().numpy()
        if tr is not None:
            tr.span("executor.to_host", t, kind="prefill")
        return out

    def _decode(self, dec: dict):
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        s = len(dec["slots"])
        bucket = 0
        if self.paged:
            dcd = self.decoder
            b = paged_model.decode_bucket(s, dcd.max_slots)
            dcd.stage(dec, b)
            bucket = b if dcd.graphed else 0
        else:
            toks = self._tensor(dec["tokens"], np.int64)
            pos = self._tensor(dec["pos"], np.int64)
            index = self._tensor(dec["slots"], np.int64)
        if tr is not None:
            t = tr.span("executor.prepare", t, kind="decode")
        if self.paged:
            logits = dcd.run(b, s)
            if bucket:
                self.graph_decodes += 1
                self.graph_padding_rows += bucket - s
        else:
            # gather the slots' caches, run decode_fn, scatter them back
            cache = {k: slab.index_select(1, index).to(self.cache_dtypes[k])
                     for k, slab in self.cache.items()}
            logits, cache = api.decode_fn(self.params, self.cfg, toks, cache,
                                          pos)
            for key, slab in self.cache.items():
                slab.index_copy_(1, index, cache[key].to(slab.dtype))
        self.decode_steps += 1
        self._count_moe(s)
        if tr is not None:
            t = tr.span("executor.launch", t, kind="decode", graph=bucket)
        out = logits.float().cpu().numpy()
        if tr is not None:
            tr.span("executor.to_host", t, kind="decode")
        return out
