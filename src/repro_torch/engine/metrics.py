"""vLLM-style engine metrics.

The Metrics Gateway scrapes `snapshot()` dicts (the paper scrapes vLLM's
Prometheus endpoint); the autoscaler's alert rule evaluates `queue_time`
sustained over time from these samples (§3.3: >5 s over 30 s -> +1 instance).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EngineMetrics:
    tokens_generated: int = 0
    tokens_prefilled: int = 0
    requests_finished: int = 0
    requests_failed: int = 0
    preemptions: int = 0
    busy_time: float = 0.0          # model execution seconds
    # disaggregated serving: prefill->decode KV handoffs through this engine
    handoffs_exported: int = 0
    handoffs_imported: int = 0
    handoff_blocks_imported: int = 0
    # handoffs rejected with a typed error (block-size mismatch) and
    # degraded to a full recompute instead of a silent mis-seal
    handoff_import_errors: int = 0
    finished: list = field(default_factory=list)  # (req metrics, out_len)

    def record_finish(self, req):
        self.requests_finished += 1
        self.finished.append((req.metrics, req.output_len))


def snapshot(engine, now: float) -> dict:
    """One Prometheus scrape."""
    sched = engine.scheduler
    m = engine.metrics
    ts = engine.allocator.tier_store
    return {
        "time": now,
        "phase": engine.phase_mode,
        "num_waiting": sched.num_waiting(),
        "num_running": sched.num_running(),
        "admission_blocked_total": sched.admission_blocked,
        "kv_utilization": sched.kv_utilization(),
        "queue_time": sched.queue_time_of_head(now),
        "tokens_generated_total": m.tokens_generated,
        "tokens_prefilled_total": m.tokens_prefilled,
        "requests_finished_total": m.requests_finished,
        "preemptions_total": m.preemptions,
        "busy_time_total": m.busy_time,
        "handoffs_exported_total": m.handoffs_exported,
        "handoffs_imported_total": m.handoffs_imported,
        "handoff_import_errors_total": m.handoff_import_errors,
        # BlockAllocator prefix-cache counters: KV-aware routing derives
        # per-endpoint windowed hit rates from consecutive scrapes of these
        "prefix_queries_total": engine.allocator.prefix_queries,
        "prefix_hits_total": engine.allocator.prefix_hits,
        # hierarchical KV tiers (repro.core.kvstore): demotion/promotion
        # flow and per-tier hits; zero when the deployment has no tiers
        "kv_demotions_total": ts.demotions if ts is not None else 0,
        "kv_promotions_total": ts.promotions if ts is not None else 0,
        "kv_host_hits_total": ts.host_hits if ts is not None else 0,
        "kv_shared_hits_total": ts.shared_hits if ts is not None else 0,
    }
