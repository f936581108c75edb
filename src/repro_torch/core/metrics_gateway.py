"""Metrics Gateway + observability stack (paper §3.2.5 / §3.3).

Serves (a) Prometheus HTTP service discovery built from ai_model_endpoints
(vLLM instances live outside the Kubernetes cluster and change addresses,
hence this workaround), (b) the scrape loop itself (standing in for
Prometheus), and (c) the Grafana-webhook endpoint whose payloads mutate the
desired instance count in ai_model_configurations — the actuation half of
the automated dynamic scaling mechanism.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.config import SLO_CLASSES
from repro_torch.core.db import Database
from repro_torch.core.simclock import EventLoop


class MetricsGateway:
    def __init__(self, db: Database, loop: EventLoop, registry: dict,
                 scrape_interval: float = 5.0, history_window: float = 600.0,
                 min_instances: int = 1, max_instances: int = 8):
        self.db = db
        self.loop = loop
        self.registry = registry
        self.history_window = history_window
        self.min_instances = min_instances
        self.max_instances = max_instances
        # (config_id) -> deque[(t, aggregated metrics dict)]
        self.history: dict[int, deque] = defaultdict(deque)
        # tenant name -> deque[(t, per-tenant usage/queue snapshot)] —
        # the per-tenant series (repro_torch.core.tenancy metering + WFQ
        # depths)
        self.tenant_history: dict[str, deque] = defaultdict(deque)
        # (node, port) -> latest per-endpoint scrape (least-loaded routing)
        self.endpoint_metrics: dict[tuple, dict] = {}
        self.scale_events: list[tuple] = []   # (t, config_id, delta, reason)
        self.web_gateway = None               # set via attach_web_gateway
        self.tenancy = None                   # TenancyManager (ControlPlane)
        self.tracer = None                    # repro_torch.core.tracing.Tracer
        self.telemetry = None                 # telemetry.TelemetryStore
        # Reconciler.patch_replicas, set by the ControlPlane: for configs
        # managed declaratively the webhook patches the deployment SPEC
        # (clamped to its min/max window) instead of mutating the DB row
        self.spec_patcher = None
        # fn(model_name) -> dict of extra Prometheus target labels or None
        # (ModelDeploymentSpec.prometheus_labels, injected by ControlPlane);
        # core labels always win over the overrides
        self.deployment_labels = None
        self._scrape_task = loop.every(scrape_interval, self.scrape)

    def stop(self):
        """Tear down the periodic scrape (no further ticks are scheduled)."""
        self._scrape_task.stop()

    def attach_web_gateway(self, gw):
        """Lets the scrape fold the gateway's queued-request depth into the
        per-config aggregates (queued demand counts toward scale-up)."""
        self.web_gateway = gw

    def _append_sample(self, series: deque, now: float, sample: dict):
        """THE history writer: every series append goes through here so
        `history_window` trimming is enforced uniformly — an unbounded
        deque on a long run is a memory leak, not a metric."""
        series.append((now, sample))
        while series and series[0][0] < now - self.history_window:
            series.popleft()

    def endpoint_load(self, key: tuple) -> dict:
        """Latest scrape snapshot for one endpoint (node, port); {} if the
        endpoint has not been scraped yet. Injected into load-aware
        routing policies as their `load_fn`."""
        return self.endpoint_metrics.get(key, {})

    # -- Prometheus HTTP service discovery --------------------------------
    def prometheus_targets(self) -> list[dict]:
        out = []
        for ep in self.db["ai_model_endpoints"].rows.values():
            if ep["ready_at"] is None:
                continue
            job = self.db["ai_model_endpoint_jobs"].get(ep["endpoint_job_id"])
            extra = self.deployment_labels(ep["model_name"]) \
                if self.deployment_labels is not None else None
            out.append({
                "targets": [f"{ep['node']}:{ep['port']}"],
                "labels": {
                    **(extra or {}),
                    "model": ep["model_name"],
                    "model_version": str(ep["model_version"]),
                    "phase": ep.get("phase") or "unified",
                    "endpoint_job_id": str(ep["endpoint_job_id"]),
                    "slurm_job_id": str(job["slurm_job_id"]) if job else "",
                    "__bearer__": ep["bearer_token"],
                },
            })
        return out

    # -- scrape loop (Prometheus stand-in) ---------------------------------
    def scrape(self, now: float = None):
        now = self.loop.now if now is None else now
        per_config = defaultdict(list)
        scraped_keys = set()
        for target in self.prometheus_targets():
            node, port = target["targets"][0].rsplit(":", 1)
            inst = self.registry.get((node, int(port)))
            if inst is None or not inst.alive:
                continue
            snap = inst.metrics_snapshot()
            self.endpoint_metrics[(node, int(port))] = snap
            scraped_keys.add((node, int(port)))
            job = self.db["ai_model_endpoint_jobs"].get(
                int(target["labels"]["endpoint_job_id"]))
            if job is None:
                continue
            per_config[job["configuration_id"]].append(snap)
        # drop snapshots of dead/decommissioned endpoints so load-aware
        # routing never reads a dead instance's last queue depth (a fresh
        # replacement may reuse the same node:port)
        for key in list(self.endpoint_metrics):
            if key not in scraped_keys:
                del self.endpoint_metrics[key]
        gw_queue = getattr(self.web_gateway, "queue", None)
        for cfg in self.db["ai_model_configurations"].rows.values():
            snaps = per_config.get(cfg["id"], [])
            queued = gw_queue.depth(cfg["model_name"]) if gw_queue else 0
            head_age = gw_queue.head_age(cfg["model_name"], now) \
                if gw_queue else 0.0
            # share-weighted tenant backlog: the worst ratio of one
            # tenant's queued depth to its fair-share weight, emitted only
            # under CONTENTION (>= 2 tenants backlogged).  A lone tenant's
            # backlog is plain demand — GATEWAY_QUEUE_SCALE_UP's job; zero
            # here keeps the two rules from double-firing on it.  With
            # contention, a deep queue on a low-weight tenant dominates
            # the signal: backlog per unit of entitled share that WFQ can
            # reorder but not serve (TENANT_QUEUE_SCALE_UP).
            tenant_q = 0.0
            if gw_queue is not None and self.tenancy is not None:
                depths = gw_queue.depth_by_tenant(cfg["model_name"])
                if len(depths) >= 2:
                    tenant_q = max(d / self.tenancy.weight(t)
                                   for t, d in depths.items())
            if snaps:
                agg = {
                    "n": len(snaps),
                    # queued gateway requests count toward the scale-up
                    # signal: the queue head's age is queue time the paper's
                    # rule would have seen inside an engine
                    "queue_time_max": max(max(s["queue_time"] for s in snaps),
                                          head_age),
                    "queue_time_min": min(s["queue_time"] for s in snaps),
                    "kv_util_avg": sum(s["kv_utilization"] for s in snaps)
                    / len(snaps),
                    "waiting_total": sum(s["num_waiting"] for s in snaps)
                    + queued,
                    "running_total": sum(s["num_running"] for s in snaps),
                    "gateway_queued": queued,
                    "tenant_queue_weighted": tenant_q,
                    # fleet-level prefix-cache effectiveness (cumulative
                    # block-level hit ratio across the config's engines);
                    # per-endpoint rates live in endpoint_metrics for the
                    # KV-aware router
                    "prefix_hit_rate": (
                        sum(s.get("prefix_hits_total", 0) for s in snaps)
                        / max(sum(s.get("prefix_queries_total", 0)
                                  for s in snaps), 1)),
                    # hierarchical KV store (repro_torch.core.kvstore):
                    # per-tier traffic across the config's engines — flat zeros when
                    # tiering is off (the engines report 0 without a store)
                    "kv_demotions_total": sum(
                        s.get("kv_demotions_total", 0) for s in snaps),
                    "kv_promotions_total": sum(
                        s.get("kv_promotions_total", 0) for s in snaps),
                    "kv_host_hits_total": sum(
                        s.get("kv_host_hits_total", 0) for s in snaps),
                    "kv_shared_hits_total": sum(
                        s.get("kv_shared_hits_total", 0) for s in snaps),
                }
                # disaggregated pools: per-phase depths so the autoscaler's
                # pool-addressed rules can grow prefill and decode capacity
                # independently (keys absent for unified deployments)
                for pool in ("prefill", "decode"):
                    phs = [s for s in snaps
                           if s.get("phase") == f"{pool}_only"]
                    if not phs:
                        continue
                    agg[f"queue_time_max_{pool}"] = max(s["queue_time"]
                                                        for s in phs)
                    agg[f"waiting_{pool}"] = sum(s["num_waiting"]
                                                 for s in phs)
                    agg[f"running_{pool}"] = sum(s["num_running"]
                                                 for s in phs)
                    agg[f"kv_util_{pool}"] = (sum(s["kv_utilization"]
                                                  for s in phs) / len(phs))
            elif queued:
                # zero live instances but queued demand: emit a partial
                # sample (no kv/running keys — series() skips them) so the
                # autoscaler still sees the backlog
                agg = {"n": 0, "queue_time_max": head_age,
                       "waiting_total": queued, "gateway_queued": queued,
                       "tenant_queue_weighted": tenant_q}
            else:
                continue
            if self.tracer is not None:
                # per-span-kind duration histograms (p50/p95/p99) plus the
                # window's SLO-miss count and exemplar trace ids, drained
                # from the tracer's pending samples for this model
                agg.update(self.tracer.fold(cfg["model_name"]))
            if self.telemetry is not None:
                # SLO burn-rate series (repro_torch.core.telemetry): the scrape
                # drives one evaluation pass on the virtual clock and
                # stores the resulting series.  Keys are spelled out as
                # literal stores (not a dict merge) so repro-lint R4/R6
                # can statically tie AlertRule metrics and the metric
                # registry to real emission sites.
                tele = self.telemetry.fold(cfg["model_name"], now)
                agg["slo_burn_fast"] = tele["slo_burn_fast"]
                agg["slo_burn_slow"] = tele["slo_burn_slow"]
                agg["slo_burn_firing"] = tele["slo_burn_firing"]
                agg["slo_shed_total"] = tele["slo_shed_total"]
                for cls in SLO_CLASSES:
                    agg[f"slo_burn_fast_{cls}"] = \
                        tele[f"slo_burn_fast_{cls}"]
                    agg[f"slo_burn_slow_{cls}"] = \
                        tele[f"slo_burn_slow_{cls}"]
                    agg[f"slo_attainment_{cls}"] = \
                        tele[f"slo_attainment_{cls}"]
            self._append_sample(self.history[cfg["id"]], now, agg)
        # per-tenant series: in-flight, queued depth and running usage
        # totals per tenant — what a per-department Grafana board plots
        # and what billing reconciles against
        if self.tenancy is not None:
            tracked = self.tenancy.tracked()
            # drop series of churned (deleted, drained) tenants, like the
            # dead-endpoint snapshot cleanup above
            for name in [n for n in self.tenant_history
                         if n not in tracked]:
                del self.tenant_history[name]
            for name in tracked:
                totals = self.tenancy.totals.get(name, {})
                snap = {
                    "inflight": self.tenancy.inflight.get(name, 0),
                    "queued": gw_queue.tenant_depth(name) if gw_queue else 0,
                    "weight": self.tenancy.weight(name),
                    "requests_total": totals.get("requests", 0),
                    "failed_total": totals.get("failed", 0),
                    "prompt_tokens_total": totals.get("prompt_tokens", 0),
                    "completion_tokens_total":
                        totals.get("completion_tokens", 0),
                    "rejected_quota_total":
                        self.tenancy.rejections.get(name, 0),
                }
                self._append_sample(self.tenant_history[name], now, snap)

    def series(self, config_id: int, metric: str, since: float) -> list[tuple]:
        """History samples carrying `metric` (partial gateway-queue samples
        omit engine metrics; those are skipped rather than zero-filled)."""
        return [(t, m[metric]) for t, m in self.history[config_id]
                if t >= since and metric in m]

    def tenant_series(self, tenant: str, metric: str,
                      since: float = 0.0) -> list[tuple]:
        """Per-tenant history samples (see scrape): `inflight`, `queued`,
        `weight`, `requests_total`, `failed_total`, `prompt_tokens_total`,
        `completion_tokens_total`, `rejected_quota_total`."""
        return [(t, m[metric]) for t, m in self.tenant_history[tenant]
                if t >= since and metric in m]

    # -- Grafana contact-point webhook --------------------------------------
    def grafana_webhook(self, payload: dict) -> int:
        """POST with a custom JSON payload from a firing alert rule.
        {"config_id": int, "delta": +1|-1, "rule": str, "pool": str|None}
        (``pool`` names the prefill/decode pool for the per-phase rules of
        disaggregated deployments; the patch then targets that pool's own
        replica window.)

        Declaratively managed configs (`spec_patcher` returns non-None):
        the alert becomes a replica-count patch on the ModelDeploymentSpec,
        clamped to the deployment's own [min_replicas, max_replicas] — the
        Reconciler then converges the cluster.  Unmanaged configs keep the
        paper's direct ``instances`` mutation, clamped to the gateway-wide
        min/max."""
        cfg = self.db["ai_model_configurations"].get(payload["config_id"])
        if cfg is None:
            return 404
        if self.spec_patcher is not None:
            patched = self.spec_patcher(payload["config_id"],
                                        payload["delta"],
                                        payload.get("rule", ""),
                                        payload.get("pool"))
            if patched is not None:
                old, new = patched
                if new != old:
                    self.scale_events.append((self.loop.now, cfg["id"],
                                              payload["delta"],
                                              payload.get("rule", "")))
                return 200
        new = max(self.min_instances,
                  min(self.max_instances, cfg["instances"] + payload["delta"]))
        if new != cfg["instances"]:
            self.db["ai_model_configurations"].update(cfg["id"], instances=new)
            self.scale_events.append((self.loop.now, cfg["id"],
                                      payload["delta"],
                                      payload.get("rule", "")))
        return 200
