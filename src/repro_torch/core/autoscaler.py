"""Grafana alert rules -> webhook -> scale (paper §3.3).

The deployed rule reproduced exactly: *vLLM queue time above 5 s sustained
for 30 s triggers instantiation of an additional model instance*. Scaling
is by hardware load (queue time / KVC utilisation reported by the engines),
not request count. A symmetric scale-down rule (idle KV + empty queue
sustained) is our beyond-paper addition — the paper plans this for
off-hours research workloads.

Actuation is indirect: the webhook lands at the Metrics Gateway, which for
declaratively managed models forwards it as a *spec patch* — the firing
rule adjusts `ModelDeploymentSpec.replicas`, clamped to the deployment's
[min_replicas, max_replicas] window, and the `Reconciler`
(repro_torch.core.deployments) converges the cluster.  The autoscaler itself
never submits or cancels jobs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.metrics_gateway import MetricsGateway
from repro_torch.core.simclock import EventLoop


@dataclass
class AlertRule:
    name: str
    metric: str                 # key in the aggregated scrape dict
    op: str                     # "gt" | "lt"
    threshold: float
    for_duration: float         # sustained seconds before firing
    delta: int                  # instances to add/remove
    cooldown: float = 60.0      # per-config refractory period
    # disaggregated deployments: which phase pool the webhook patch targets
    # (None = the deployment's replicas / decode pool by default)
    pool: Optional[str] = None

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.op == "gt" \
            else value < self.threshold


def rule_from_dict(d: dict) -> AlertRule:
    """Build an AlertRule from its manifest form — the entries of
    `ModelDeploymentSpec.alert_rules` (per-deployment overrides of the
    global rule set; validated at apply time by the spec)."""
    return AlertRule(name=d["name"], metric=d["metric"], op=d["op"],
                     threshold=float(d["threshold"]),
                     for_duration=float(d["for_duration"]),
                     delta=int(d["delta"]),
                     cooldown=float(d.get("cooldown", 60.0)),
                     pool=d.get("pool"))


QUEUE_TIME_SCALE_UP = AlertRule(
    name="queue_time>5s_for_30s", metric="queue_time_max", op="gt",
    threshold=5.0, for_duration=30.0, delta=+1, cooldown=60.0)

IDLE_SCALE_DOWN = AlertRule(
    name="idle_kv<2%_for_300s", metric="kv_util_avg", op="lt",
    threshold=0.02, for_duration=300.0, delta=-1, cooldown=300.0)

# beyond-paper: requests parked in the Web Gateway's router-side queue are
# demand no engine can report (there may be zero live instances); sustained
# gateway backlog triggers scale-up just like engine queue time. Inert
# unless ServiceConfig.queue_capacity > 0 (gateway_queued is then scraped).
GATEWAY_QUEUE_SCALE_UP = AlertRule(
    name="gateway_queue>0_for_15s", metric="gateway_queued", op="gt",
    threshold=0.5, for_duration=15.0, delta=+1, cooldown=60.0)

# multi-tenant QoS (repro_torch.core.tenancy): `tenant_queue_weighted` is the
# worst per-tenant backlog *normalised by that tenant's fair-share
# weight*, emitted only while >= 2 tenants are backlogged on the model.
# It measures contention WFQ can reorder but not serve: a deep queue on
# a low-weight (small-share) tenant dominates the signal, because that
# backlog represents many multiples of the share the cluster owes it.
# A single tenant's backlog keeps the metric at zero — that is plain
# demand, covered by GATEWAY_QUEUE_SCALE_UP, and the two rules must not
# double-fire on it.
TENANT_QUEUE_SCALE_UP = AlertRule(
    name="tenant_weighted_queue>4_for_15s", metric="tenant_queue_weighted",
    op="gt", threshold=4.0, for_duration=15.0, delta=+1, cooldown=60.0)

# disaggregated deployments (repro_torch.core.disagg): the Metrics Gateway
# scrapes per-phase queue depths (`queue_time_max_prefill` / `_decode`),
# so prefill and decode pools grow independently — sustained prefill
# backlog must not add decode replicas and vice versa.  Inert for unified
# deployments (the metrics are absent from their scrape aggregates).
PREFILL_QUEUE_SCALE_UP = AlertRule(
    name="prefill_queue_time>5s_for_30s", metric="queue_time_max_prefill",
    op="gt", threshold=5.0, for_duration=30.0, delta=+1, cooldown=60.0,
    pool="prefill")

DECODE_QUEUE_SCALE_UP = AlertRule(
    name="decode_queue_time>5s_for_30s", metric="queue_time_max_decode",
    op="gt", threshold=5.0, for_duration=30.0, delta=+1, cooldown=60.0,
    pool="decode")

# SLO burn-rate scale-up (repro_torch.core.telemetry, docs/observability.md):
# scales on *attainment itself* instead of a queue-depth proxy —
# `slo_burn_fast` is the worst per-class fast-pair burn (the min of the
# short/long windows, so a transient spike the long window has not
# confirmed does not scale).  burn > 1 sustained means the error budget
# is burning faster than the objective allows even if no queue metric
# looks alarming yet (e.g. a straggler chip blowing TTFT at shallow
# queues).  ``pool="burning"`` is a sentinel the evaluator resolves at
# fire time through `Autoscaler.pool_hint`: the webhook patch targets
# whichever pool's span histogram is actually burning (decode-span burn
# -> decode pool, prefill-span burn -> prefill pool, queue burn -> the
# deployment's plain replica count).  Not in the default rule set:
# deployments opt in via `ModelDeploymentSpec.alert_rules` (or the
# ControlPlane's alert_rules argument).
SLO_BURN_SCALE_UP = AlertRule(
    name="slo_burn_fast>1_for_20s", metric="slo_burn_fast", op="gt",
    threshold=1.0, for_duration=20.0, delta=+1, cooldown=60.0,
    pool="burning")


class Autoscaler:
    """Evaluates alert rules over the scrape history and fires the Grafana
    contact-point webhook at the Metrics Gateway."""

    def __init__(self, gw: MetricsGateway, loop: EventLoop,
                 rules: Optional[list[AlertRule]] = None,
                 eval_interval: float = 10.0):
        self.gw = gw
        self.loop = loop
        self.rules = rules if rules is not None \
            else [QUEUE_TIME_SCALE_UP, GATEWAY_QUEUE_SCALE_UP,
                  TENANT_QUEUE_SCALE_UP,
                  PREFILL_QUEUE_SCALE_UP, DECODE_QUEUE_SCALE_UP,
                  IDLE_SCALE_DOWN]
        # per-deployment rule overrides: fn(config_id) -> list[AlertRule]
        # or None to fall back to the global `rules` (injected by the
        # ControlPlane, which resolves ModelDeploymentSpec.alert_rules)
        self.rules_for = None
        # fn(config_id) -> "prefill" | "decode" | None: resolves the
        # ``pool="burning"`` sentinel of SLO_BURN_SCALE_UP at fire time
        # to the pool whose span histogram the firing burn alert blames
        # (injected by the ControlPlane from the TelemetryStore)
        self.pool_hint = None
        # (config_id, rule name) -> breach start time
        self._pending: dict[tuple, float] = {}
        self._last_fired: dict[tuple, float] = {}
        self.fired: list[tuple] = []   # (t, config_id, rule)
        self._eval_task = loop.every(eval_interval, self.evaluate)

    def stop(self):
        """Tear down the periodic rule evaluation."""
        self._eval_task.stop()

    def evaluate(self, now: float = None):
        now = self.loop.now if now is None else now
        for cfg_id in list(self.gw.history.keys()):
            override = self.rules_for(cfg_id) \
                if self.rules_for is not None else None
            for rule in (override if override is not None else self.rules):
                key = (cfg_id, rule.name)
                series = self.gw.series(cfg_id, rule.metric,
                                        now - rule.for_duration - 1e-9)
                if not series:
                    self._pending.pop(key, None)
                    continue
                latest = series[-1][1]
                if not rule.breached(latest):
                    self._pending.pop(key, None)
                    continue
                start = self._pending.setdefault(key, now)
                # sustained: every sample within the window breached
                window = [v for t, v in series if t >= now - rule.for_duration]
                sustained = (now - start >= rule.for_duration
                             and window and all(rule.breached(v)
                                                for v in window))
                if not sustained:
                    continue
                last = self._last_fired.get(key, -1e18)
                if now - last < rule.cooldown:
                    continue
                self._last_fired[key] = now
                self._pending.pop(key, None)
                self.fired.append((now, cfg_id, rule.name))
                pool = rule.pool
                if pool == "burning":
                    # late binding on purpose: the burning pool is a
                    # property of the INCIDENT (which span family is
                    # accumulating time), not of the rule
                    pool = self.pool_hint(cfg_id) \
                        if self.pool_hint is not None else None
                self.gw.grafana_webhook({"config_id": cfg_id,
                                         "delta": rule.delta,
                                         "rule": rule.name,
                                         "pool": pool})
