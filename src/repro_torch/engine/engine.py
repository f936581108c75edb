"""LLMEngine: the vLLM analogue (one per Slurm job in the paper's layer 2).

The engine owns: FCFS continuous-batching scheduler, paged-KV control plane,
an executor (real PyTorch compute or the roofline simulator) and per-request
streaming. Time is injected (`now`) so the whole serving stack runs on the
control-plane's virtual clock; `step()` returns the model time consumed so
the caller can advance it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.engine.kv_cache import BlockAllocator, HandoffBlockSizeMismatch, \
    export_handoff, import_handoff
from repro_torch.engine.metrics import EngineMetrics, snapshot
from repro_torch.engine.request import Request, RequestStatus
from repro_torch.engine.scheduler import PHASE_MODES, Scheduler


@dataclass
class StepReport:
    kind: str                  # prefill | decode | idle
    elapsed: float
    tokens: int = 0
    finished: int = 0


class LLMEngine:
    def __init__(self, cfg, executor, num_blocks: int = 4096,
                 block_size: int = 32, max_num_seqs: int = 64,
                 max_prefill_tokens: int = 2048, max_model_len: int = 8192,
                 enable_prefix_caching: bool = True,
                 phase_mode: str = "unified"):
        self.cfg = cfg
        self.executor = executor
        self.allocator = BlockAllocator(
            num_blocks, block_size, enable_prefix_caching=enable_prefix_caching)
        self.scheduler = Scheduler(self.allocator, max_num_seqs=max_num_seqs,
                                   max_prefill_tokens=max_prefill_tokens,
                                   max_model_len=max_model_len,
                                   phase_mode=phase_mode)
        self.phase_mode = phase_mode
        # disaggregation hook: fn(req, KVHandoff, now) fired by a
        # prefill-only engine once a request's first token is out and its
        # sealed blocks are exported (wired to the gateway's two-hop path)
        self.on_handoff = None
        self.metrics = EngineMetrics()
        self._rng = np.random.default_rng(0)
        # a StepTracer (engine/steptrace.py) records each step's spans
        self.tracer = None

    def set_phase(self, phase_mode: str):
        """Specialise this engine to one serving phase (disaggregated
        pools); engines default to the paper's unified behaviour."""
        assert phase_mode in PHASE_MODES, phase_mode
        self.phase_mode = phase_mode
        self.scheduler.phase_mode = phase_mode

    # ------------------------------------------------------------------
    def add_request(self, req: Request, now: float):
        req.sampling.validate()
        if req.handoff is not None:
            # decode hop: re-materialise the prefill pool's sealed blocks
            # so admission's match_prefix reattaches them instead of
            # recomputing the whole prompt
            try:
                n = import_handoff(self.allocator, req.handoff)
            except HandoffBlockSizeMismatch:
                # heterogeneous pools: the handoff's hashes are useless
                # here — degrade to a full recompute, but observably
                self.metrics.handoff_import_errors += 1
            else:
                self.metrics.handoffs_imported += 1
                self.metrics.handoff_blocks_imported += n
        self.scheduler.add_request(req, now)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def snapshot(self, now: float) -> dict:
        return snapshot(self, now)

    # ------------------------------------------------------------------
    def _sample(self, req: Request, logits: Optional[np.ndarray]) -> int:
        sp = req.sampling
        if logits is None:  # sim executor: synthesise deterministic ids
            # repro-lint: disable-next-line=R1(int-only tuple; unsalted, PYTHONHASHSEED-independent)
            return int((hash((req.request_id, req.output_len)) % 1000) + 2)
        logits = np.asarray(logits, np.float64)
        if sp.temperature <= 1e-5:
            return int(np.argmax(logits))
        logits = logits / sp.temperature
        if sp.top_k:
            kth = np.partition(logits, -sp.top_k)[-sp.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        if sp.top_p < 1.0:
            order = np.argsort(-probs)
            csum = np.cumsum(probs[order])
            cut = np.searchsorted(csum, sp.top_p) + 1
            mask = np.zeros_like(probs)
            mask[order[:cut]] = 1.0
            probs = probs * mask
            probs /= probs.sum()
        rng = np.random.default_rng((sp.seed, req.request_id, req.output_len))
        return int(rng.choice(len(probs), p=probs))

    def _emit(self, seq, token: int, now: float):
        req = seq.req
        req.output_tokens.append(token)
        if req.metrics.first_token_time is None:
            req.metrics.first_token_time = now
        done = req.is_finished(token)
        if req.trace is not None:
            # span transitions are trace-only and must precede the token
            # callback (the stream closes inside it and the tracer's
            # terminal hook walks the tree) — but the METRIC stamps below
            # stay after it, matching what every stream-close observer
            # (tenancy accounting, router note_finish) has always seen
            pre = req.trace.open_span("engine.prefill")
            if pre is not None:
                pre.close(now, tokens=req.prompt_len)
                if not done and self.phase_mode != "prefill_only":
                    req.trace.start_span("engine.decode", now)
            if done:
                req.trace.close_span("engine.decode", now,
                                     tokens=req.output_len)
        if req.on_token is not None:
            req.on_token(req, token, now)
        if done:
            req.metrics.finish_time = now
            req.metrics.prompt_tokens = req.prompt_len
            req.metrics.completion_tokens = req.output_len
            self.metrics.record_finish(req)
            self.scheduler.finish_seq(seq)
            return True
        return False

    # ------------------------------------------------------------------
    def step(self, now: float) -> StepReport:
        tr = self.tracer
        if tr is not None:
            t0 = tr.now()
        out = self.scheduler.schedule(now)
        self.metrics.preemptions += len(out.preempted)
        if out.kind == "idle":
            return StepReport("idle", 0.0)

        prefill_specs = [{
            "token_ids": seq.req.prompt_tokens,
            "block_table": seq.kv.block_table,
            "chunk": chunk,
            "is_last": seq.prompt_done,
            "slot": seq.slot,
        } for seq, chunk in out.prefills]
        decode_spec = None
        if out.decode:
            decode_spec = {
                "slots": [s.slot for s in out.decode],
                "tokens": [s.req.output_tokens[-1] if s.req.output_tokens
                           else s.req.prompt_tokens[-1] for s in out.decode],
                # position of the token being fed = index of its KV slot
                "pos": [s.kv.num_tokens - 1 for s in out.decode],
                "block_tables": [s.kv.block_table for s in out.decode],
            }
        if tr is not None:
            tr.begin(t0)
            tr.span("engine.schedule", t0)

        pre_logits, dec_logits, elapsed = self.executor.step(
            prefill_specs, decode_spec)
        self.metrics.busy_time += elapsed
        t_done = now + elapsed
        finished = 0
        tokens = 0
        if tr is not None:
            t1 = tr.now()

        if out.decode:
            for i, s in enumerate(out.decode):
                row = None if dec_logits is None else dec_logits[i]
                finished += int(self._emit(s, self._sample(s.req, row),
                                           t_done))
            self.metrics.tokens_generated += len(out.decode)
            tokens += len(out.decode)

        for i, (seq, (start, end)) in enumerate(out.prefills):
            self.metrics.tokens_prefilled += end - start
            tokens += end - start
            if seq.prompt_done and not seq.req.output_tokens:
                row = pre_logits[i] if pre_logits else None
                tok = self._sample(seq.req, row)
                done = self._emit(seq, tok, t_done)
                finished += int(done)
                if not done and self.phase_mode == "prefill_only":
                    # first token is out; hand the sealed prompt KV to the
                    # decode pool instead of decoding here
                    self._export_handoff(seq, t_done)
            # a resumed decode hop reaching prompt_done (tail recompute)
            # already carries its first token — no sample, no handoff; the
            # next step decodes it like any running sequence

        if tr is not None:
            tr.span("engine.sample", t1)
            tr.close()
        return StepReport("mixed", elapsed, tokens=tokens, finished=finished)

    # -- disaggregation (repro.core.disagg) ------------------------------
    def _export_handoff(self, seq, now: float):
        req = seq.req
        cost = getattr(self.executor, "cost", None)
        bpt = getattr(cost, "kv_bytes_per_token", 0.0) if cost else 0.0
        handoff = export_handoff(req.prompt_tokens,
                                 self.allocator.block_size,
                                 first_token=req.output_tokens[-1],
                                 kv_bytes_per_token=bpt)
        # release the slot and blocks: sealed blocks stay warm in the
        # evictable pool, so shared prefixes keep hitting on this instance
        self.scheduler.finish_seq(seq, status=RequestStatus.MIGRATING)
        req.handoff = handoff
        self.metrics.handoffs_exported += 1
        if self.on_handoff is not None:
            self.on_handoff(req, handoff, now)
