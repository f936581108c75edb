"""Declarative control-plane API: ModelDeployment specs, status conditions
and the reconciler loop (Kubernetes-operator style, beyond-paper).

The paper's management components are imperative: the Job Worker counts
rows, the Grafana webhook mutates ``ai_model_configurations.instances``
directly, and there is no object an operator can apply, diff or watch.
This module adds the declarative surface Chat AI (arXiv 2407.00110) and
the production-stack router get from Kubernetes CRDs:

* `ModelDeploymentSpec`  — desired state: model + replica window
  (``min_replicas``/``max_replicas``/``replicas``), per-deployment routing
  policy and gateway-queue knobs, Slurm priority class and
  hardware/partition requirements.  Strictly validated, ``to_dict`` /
  ``from_dict`` round-trips (the wire contract, `repro_torch.api.schemas`
  style).
* `DeploymentStatus`     — observed state: ready/starting/pending/draining
  replica counts, a typed `Condition` list (Available / Ready /
  Progressing) and ``observed_generation`` which lags ``generation`` until
  the reconciler has fully converged.
* `Reconciler`           — the control loop: each tick it observes the
  endpoint-job rows + Slurm states, executes at most one submission
  (the paper's Job-Worker pacing) plus any drains/cancels, and updates
  status.  Scale-down *drains* ready replicas (stop routing, let in-flight
  requests finish, then ``scancel``); template changes (model version /
  hardware shape) roll: surge one fresh replica, retire one stale replica
  at a time, never letting ready replicas fall below ``min_replicas``.
  Node failure is not a special case — observed replicas drop below spec
  and the same loop restores them.

The Autoscaler actuates through `patch_replicas`: alert webhooks become
replica-count *patches on the spec*, clamped to the deployment's
min/max window, instead of raw DB writes (see
`MetricsGateway.grafana_webhook`).  Everything here is driven by
`repro_torch.api.admin.AdminClient`, the kubectl-shaped facade.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.api.errors import check_int as _check_int
from repro_torch.api.errors import check_number as _check_number
from repro_torch.api.errors import raise_validation as _fail
from repro_torch.core.db import Database
from repro_torch.core.disagg import DisaggProfile, DisaggregationSpec
from repro_torch.core.kvstore import KVStoreSpec
from repro_torch.core.router import POLICIES, endpoint_key
from repro_torch.core.simclock import EventLoop
from repro_torch.core.telemetry import metric_error as _metric_error
from repro_torch.core.slurm import JobState, SimSlurm

# condition types (k8s Deployment-style)
COND_AVAILABLE = "Available"      # ready replicas >= min_replicas
COND_READY = "Ready"              # fully converged with the current spec
COND_PROGRESSING = "Progressing"  # reconciler still has work to do

#: spec revisions kept per deployment for `rollback` (kubectl's
#: --revision-history-limit analogue)
MAX_REVISIONS = 10


@dataclass
class ModelDeploymentSpec:
    """Desired state of one served model — the single source of truth the
    reconciler converges the cluster toward."""
    model: str
    model_version: str = "1"
    # replica window: `replicas` is the current target (patched by the
    # autoscaler), clamped to [min_replicas, max_replicas]
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 8
    # per-deployment gateway behaviour (None = inherit the gateway default)
    routing_policy: Optional[str] = None
    queue_capacity: Optional[int] = None
    queue_ttl: Optional[float] = None
    # Slurm scheduling priority for this deployment's jobs (higher first)
    priority_class: int = 0
    # hardware / partition requirements (the job template)
    gpus_per_node: int = 1
    nodes: int = 1
    partition: str = "gpu"
    est_load_time: float = 120.0
    max_model_len: Optional[int] = None
    # seconds a draining replica may keep serving in-flight requests
    # before it is force-cancelled
    drain_grace: float = 120.0
    # rolling-update budgets (k8s Deployment semantics): up to `max_surge`
    # extra replicas may run above the target while stale ones retire;
    # `max_unavailable` ready replicas may be missing below the target
    # during the update (None = legacy behaviour: retire one ready stale
    # replica per tick, only while a fresh one is ready and the ready
    # count stays >= min_replicas)
    max_surge: int = 1
    max_unavailable: Optional[int] = None
    # prefill/decode pool split (repro_torch.core.disagg); None = unified.
    # With a block set, `replicas` is inert — each pool has its own
    # replica window and the deployment reconciles both.
    disaggregation: Optional[DisaggregationSpec] = None
    # hierarchical KV tier sizing (repro_torch.core.kvstore); None = evicted
    # prompt KV is discarded, the pre-tiering behaviour
    kv_store: Optional[KVStoreSpec] = None
    # extra static labels stamped on this deployment's Prometheus scrape
    # targets (team/cost-center/dashboard routing); reserved target keys
    # (model, phase, __bearer__, ...) always win on collision
    prometheus_labels: Optional[dict] = None
    # per-deployment alert-rule overrides: a list of AlertRule manifests
    # (repro_torch.core.autoscaler.rule_from_dict) replacing the GLOBAL rule
    # set for this deployment's config; None inherits the global rules
    alert_rules: Optional[list] = None

    def validate(self):
        """Strict field-addressed validation — violations raise a 422
        `APIStatusError` whose ``param`` names the field (same contract as
        the serving schemas)."""
        if not isinstance(self.model, str) or not self.model:
            _fail("model", "model must be a non-empty string")
        if not isinstance(self.model_version, str) or not self.model_version:
            _fail("model_version", "model_version must be a non-empty string")
        _check_int(self.min_replicas, "min_replicas", minimum=0)
        _check_int(self.max_replicas, "max_replicas", minimum=1)
        if self.max_replicas < self.min_replicas:
            _fail("max_replicas",
                  f"max_replicas {self.max_replicas} must be >= "
                  f"min_replicas {self.min_replicas}")
        _check_int(self.replicas, "replicas", minimum=0)
        if not (self.min_replicas <= self.replicas <= self.max_replicas):
            _fail("replicas",
                  f"replicas {self.replicas} must lie in "
                  f"[{self.min_replicas}, {self.max_replicas}]")
        if self.routing_policy is not None \
                and self.routing_policy not in POLICIES:
            _fail("routing_policy",
                  f"routing_policy {self.routing_policy!r} must be one of "
                  f"{sorted(POLICIES)} (or null)")
        if self.queue_capacity is not None:
            _check_int(self.queue_capacity, "queue_capacity", minimum=0)
        if self.queue_ttl is not None:
            _check_number(self.queue_ttl, "queue_ttl", minimum=1e-9)
        _check_int(self.priority_class, "priority_class")
        _check_int(self.gpus_per_node, "gpus_per_node", minimum=1)
        _check_int(self.nodes, "nodes", minimum=1)
        if not isinstance(self.partition, str) or not self.partition:
            _fail("partition", "partition must be a non-empty string")
        _check_number(self.est_load_time, "est_load_time")
        if self.max_model_len is not None:
            _check_int(self.max_model_len, "max_model_len", minimum=1)
        _check_number(self.drain_grace, "drain_grace")
        _check_int(self.max_surge, "max_surge", minimum=0)
        if self.max_unavailable is not None:
            _check_int(self.max_unavailable, "max_unavailable", minimum=0)
            if self.max_surge == 0 and self.max_unavailable == 0:
                _fail("max_surge",
                      "max_surge and max_unavailable cannot both be 0 "
                      "(a rolling update could never make progress)")
        if self.disaggregation is not None:
            if not isinstance(self.disaggregation, DisaggregationSpec):
                _fail("disaggregation",
                      "disaggregation must be a DisaggregationSpec (or its "
                      "dict manifest form) or null")
            self.disaggregation.validate()
        if self.kv_store is not None:
            if not isinstance(self.kv_store, KVStoreSpec):
                _fail("kv_store",
                      "kv_store must be a KVStoreSpec (or its dict "
                      "manifest form) or null")
            self.kv_store.validate()
        if self.prometheus_labels is not None:
            if not isinstance(self.prometheus_labels, dict):
                _fail("prometheus_labels",
                      "prometheus_labels must be a dict of string labels "
                      "or null")
            for k, v in self.prometheus_labels.items():
                if not isinstance(k, str) or not k or not isinstance(v, str):
                    _fail(f"prometheus_labels.{k}",
                          "prometheus label names must be non-empty strings "
                          "and values strings")
        if self.alert_rules is not None:
            if not isinstance(self.alert_rules, list):
                _fail("alert_rules",
                      "alert_rules must be a list of alert-rule manifests "
                      "or null")
            for i, r in enumerate(self.alert_rules):
                self._validate_alert_rule(r, f"alert_rules[{i}]")

    @staticmethod
    def _validate_alert_rule(r, param: str):
        """One alert-rule manifest (repro_torch.core.autoscaler.rule_from_dict
        consumes the validated form)."""
        if not isinstance(r, dict):
            _fail(param, "alert-rule manifests must be dicts")
        required = ("name", "metric", "op", "threshold", "for_duration",
                    "delta")
        known = set(required) | {"cooldown", "pool"}
        unknown = sorted(set(r) - known)
        if unknown:
            _fail(f"{param}.{unknown[0]}",
                  f"unknown field(s) {unknown} in alert-rule manifest")
        for k in required:
            if k not in r:
                _fail(f"{param}.{k}",
                      f"alert-rule manifest requires {k!r}")
        if not isinstance(r["name"], str) or not r["name"]:
            _fail(f"{param}.name", "name must be a non-empty string")
        if not isinstance(r["metric"], str) or not r["metric"]:
            _fail(f"{param}.metric", "metric must be a non-empty string")
        # the metric must be a DECLARED series (telemetry.METRIC_REGISTRY):
        # a typo'd key or unknown span kind is a rule that silently never
        # fires — an autoscaler outage, surfaced here as a 422 instead
        metric_err = _metric_error(r["metric"])
        if metric_err is not None:
            _fail(f"{param}.metric", metric_err)
        if r["op"] not in ("gt", "lt"):
            _fail(f"{param}.op", f"op {r['op']!r} must be 'gt' or 'lt'")
        _check_number(r["threshold"], f"{param}.threshold")
        _check_number(r["for_duration"], f"{param}.for_duration",
                      minimum=0.0)
        _check_int(r["delta"], f"{param}.delta")
        if "cooldown" in r:
            _check_number(r["cooldown"], f"{param}.cooldown", minimum=0.0)
        if r.get("pool") not in (None, "prefill", "decode", "burning"):
            _fail(f"{param}.pool",
                  f"pool {r['pool']!r} must be 'prefill', 'decode', "
                  f"'burning' (resolved at fire time to the pool the burn "
                  f"alert blames) or null")

    def template(self) -> tuple:
        """The replica template: fields whose change requires replacing
        running replicas (rolling update) rather than patching in place."""
        return (self.model_version, self.gpus_per_node, self.nodes,
                self.partition, self.est_load_time, self.max_model_len)

    def to_dict(self) -> dict:
        return {"model": self.model, "model_version": self.model_version,
                "replicas": self.replicas,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "routing_policy": self.routing_policy,
                "queue_capacity": self.queue_capacity,
                "queue_ttl": self.queue_ttl,
                "priority_class": self.priority_class,
                "gpus_per_node": self.gpus_per_node, "nodes": self.nodes,
                "partition": self.partition,
                "est_load_time": self.est_load_time,
                "max_model_len": self.max_model_len,
                "drain_grace": self.drain_grace,
                "max_surge": self.max_surge,
                "max_unavailable": self.max_unavailable,
                "disaggregation": None if self.disaggregation is None
                else self.disaggregation.to_dict(),
                "kv_store": None if self.kv_store is None
                else self.kv_store.to_dict(),
                "prometheus_labels": None if self.prometheus_labels is None
                else dict(self.prometheus_labels),
                "alert_rules": None if self.alert_rules is None
                else [dict(r) for r in self.alert_rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "ModelDeploymentSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            _fail(unknown[0],
                  f"unknown field(s) {unknown} in ModelDeploymentSpec "
                  f"manifest")
        d = dict(d)
        if isinstance(d.get("disaggregation"), dict):
            d["disaggregation"] = DisaggregationSpec.from_dict(
                d["disaggregation"])
        if isinstance(d.get("kv_store"), dict):
            d["kv_store"] = KVStoreSpec.from_dict(d["kv_store"])
        return cls(**d)


@dataclass
class Condition:
    """One typed observation about the deployment, k8s-condition shaped."""
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0

    def to_dict(self) -> dict:
        return {"type": self.type, "status": self.status,
                "reason": self.reason, "message": self.message,
                "last_transition_time": self.last_transition_time}

    @classmethod
    def from_dict(cls, d: dict) -> "Condition":
        return cls(type=d["type"], status=d["status"],
                   reason=d.get("reason", ""), message=d.get("message", ""),
                   last_transition_time=d.get("last_transition_time", 0.0))


@dataclass
class DeploymentStatus:
    """Observed state, refreshed on every reconcile tick."""
    replicas: int = 0             # live jobs (incl. draining)
    ready_replicas: int = 0       # serving traffic (excl. draining)
    starting_replicas: int = 0    # Slurm RUNNING, weights still loading
    pending_replicas: int = 0     # Slurm PENDING (no node yet)
    draining_replicas: int = 0    # finishing in-flight work before scancel
    observed_generation: int = 0  # == generation only once converged
    conditions: list = field(default_factory=list)   # list[Condition]

    def condition(self, ctype: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def set_condition(self, ctype: str, status: bool, reason: str,
                      message: str, now: float) -> bool:
        """Upsert; returns True when the condition *status* flipped (the
        k8s transition semantics — reason/message refresh silently)."""
        cond = self.condition(ctype)
        if cond is None:
            self.conditions.append(Condition(
                type=ctype, status=status, reason=reason, message=message,
                last_transition_time=now))
            return True
        flipped = cond.status != status
        if flipped:
            cond.last_transition_time = now
        cond.status = status
        cond.reason = reason
        cond.message = message
        return flipped

    def to_dict(self) -> dict:
        return {"replicas": self.replicas,
                "ready_replicas": self.ready_replicas,
                "starting_replicas": self.starting_replicas,
                "pending_replicas": self.pending_replicas,
                "draining_replicas": self.draining_replicas,
                "observed_generation": self.observed_generation,
                "conditions": [c.to_dict() for c in self.conditions]}


@dataclass
class ModelDeployment:
    """spec + status + bookkeeping for one declaratively managed model."""
    name: str
    spec: ModelDeploymentSpec
    status: DeploymentStatus = field(default_factory=DeploymentStatus)
    generation: int = 1            # bumped on every spec change
    template_generation: int = 1   # bumped when spec.template() changes
    config_id: Optional[int] = None   # backing ai_model_configurations row
    # (t, condition type, new status, reason) — every condition flip, so
    # benchmarks can report e.g. the Ready False->True recovery transition
    transitions: list = field(default_factory=list)
    # previous spec snapshots, oldest -> newest (kubectl rollout history):
    # every applied spec change pushes the outgoing spec; `rollback`
    # re-applies the newest entry.  Bounded to MAX_REVISIONS.
    revisions: list = field(default_factory=list)
    # endpoint-job row id -> template_generation it was submitted under
    _job_template: dict = field(default_factory=dict)
    # endpoint-job row id -> drain deadline (force-scancel time)
    _draining: dict = field(default_factory=dict)

    @property
    def desired_replicas(self) -> int:
        s = self.spec
        if s.disaggregation is not None:
            return sum(n for _, n in self.pool_targets())
        return max(s.min_replicas, min(s.max_replicas, s.replicas))

    def pool_targets(self) -> list:
        """[(phase, desired)] — one (None, n) pool for unified deployments,
        a (prefill, n)/(decode, m) pair for disaggregated ones."""
        dis = self.spec.disaggregation
        if dis is None:
            s = self.spec
            return [(None, max(s.min_replicas,
                               min(s.max_replicas, s.replicas)))]
        return [("prefill", dis.desired("prefill")),
                ("decode", dis.desired("decode"))]

    def pool_floor(self, phase) -> int:
        """Ready-replica floor during scale-down / rolling updates."""
        dis = self.spec.disaggregation
        if dis is None or phase is None:
            return self.spec.min_replicas
        return dis.window(phase)[0]

    def to_dict(self) -> dict:
        return {"name": self.name, "generation": self.generation,
                "template_generation": self.template_generation,
                "spec": self.spec.to_dict(),
                "status": self.status.to_dict()}


class Reconciler:
    """The declarative control loop: `deployments` holds desired state,
    every tick observes the cluster and converges it.  The Job Worker acts
    purely as the reconcile *executor* (`submit_one`) for managed configs;
    its own legacy loop skips them (see `JobWorker.managed`)."""

    def __init__(self, db: Database, loop: EventLoop, slurm: SimSlurm,
                 job_worker, registry: dict, interval: float = 5.0,
                 gateway=None, default_max_model_len: int = 8192,
                 known_models: Optional[Callable[[str], bool]] = None):
        self.db = db
        self.loop = loop
        self.slurm = slurm
        self.job_worker = job_worker
        self.registry = registry              # (node, port) -> VLLMInstance
        self.gateway = gateway                # WebGateway (policy/queue wiring)
        self.default_max_model_len = default_max_model_len
        self.known_models = known_models
        self.deployments: dict[str, ModelDeployment] = {}
        self._by_config: dict[int, ModelDeployment] = {}
        self._watchers: list[Callable[[dict], None]] = []
        self._tick = loop.every(interval, self.reconcile)

    def stop(self):
        """Tear down the reconcile loop: the pending tick is cancelled and
        no further reconcile events are ever scheduled (regression-tested
        in tests/test_determinism.py)."""
        self._tick.stop()

    # ------------------------------------------------------------------
    # kubectl-shaped verbs (wrapped by repro_torch.api.admin.AdminClient)
    # ------------------------------------------------------------------
    def apply(self, spec) -> ModelDeployment:
        """Create or update the deployment named by ``spec.model``.
        Accepts a `ModelDeploymentSpec` or its dict form.  An apply that
        changes nothing is a no-op (generation unchanged)."""
        if isinstance(spec, dict):
            spec = ModelDeploymentSpec.from_dict(spec)
        spec.validate()
        if self.known_models is not None and not self.known_models(spec.model):
            _fail("model", f"model {spec.model!r} has no registered "
                           f"ModelConfig (ControlPlane.register_model)")
        dep = self.deployments.get(spec.model)
        if dep is None:
            row = self.db["ai_model_configurations"].insert(
                self.db, model_name=spec.model,
                model_version=spec.model_version,
                instances=spec.replicas, gpus_per_node=spec.gpus_per_node,
                nodes=spec.nodes, est_load_time=spec.est_load_time,
                max_model_len=spec.max_model_len or self.default_max_model_len,
                slurm_partition=spec.partition)
            dep = ModelDeployment(name=spec.model, spec=spec,
                                  config_id=row["id"])
            self.deployments[spec.model] = dep
            self._by_config[row["id"]] = dep
            self.job_worker.managed.add(row["id"])
            self._wire_gateway(dep)
            self._emit("ADDED", dep)
            self._update_status(dep, dep.desired_replicas, self.loop.now)
            return dep
        if spec == dep.spec:
            return dep
        template_changed = spec.template() != dep.spec.template()
        # snapshot the outgoing spec (deep copy via the manifest: later
        # autoscaler patches mutate dep.spec in place and must not reach
        # into the revision history)
        dep.revisions.append(ModelDeploymentSpec.from_dict(
            dep.spec.to_dict()))
        del dep.revisions[:-MAX_REVISIONS]
        dep.spec = spec
        dep.generation += 1
        if template_changed:
            dep.template_generation += 1
            self.db["ai_model_configurations"].update(
                dep.config_id, model_version=spec.model_version,
                gpus_per_node=spec.gpus_per_node, nodes=spec.nodes,
                est_load_time=spec.est_load_time,
                max_model_len=spec.max_model_len or self.default_max_model_len,
                slurm_partition=spec.partition)
        self._wire_gateway(dep)
        self._emit("MODIFIED", dep)
        # refresh conditions NOW: a spec the cluster no longer satisfies
        # must flip Ready before the next tick (AdminClient.wait relies on
        # conditions never being stale across a verb)
        self._update_status(dep, dep.desired_replicas, self.loop.now)
        return dep

    def get(self, name: str) -> Optional[ModelDeployment]:
        return self.deployments.get(name)

    def list(self) -> list:
        return list(self.deployments.values())

    def scale(self, name: str, replicas: int) -> ModelDeployment:
        """kubectl scale: patch only spec.replicas (within [min, max])."""
        dep = self.deployments.get(name)
        if dep is None:
            _fail("name", f"no deployment named {name!r}")
        _check_int(replicas, "replicas", minimum=0)
        if not (dep.spec.min_replicas <= replicas <= dep.spec.max_replicas):
            _fail("replicas",
                  f"replicas {replicas} must lie in "
                  f"[{dep.spec.min_replicas}, {dep.spec.max_replicas}]")
        if replicas != dep.spec.replicas:
            dep.spec.replicas = replicas
            dep.generation += 1
            self._emit("SCALED", dep)
            self._update_status(dep, dep.desired_replicas, self.loop.now)
        return dep

    def rollback(self, name: str) -> ModelDeployment:
        """kubectl rollout undo: re-apply the previous spec revision.
        Template changes roll back with the same surge/drain machinery a
        forward update uses; a second rollback returns to where you
        started (the undone spec is itself pushed as a revision)."""
        dep = self.deployments.get(name)
        if dep is None:
            _fail("name", f"no deployment named {name!r}")
        # in-place drift (autoscaler patch_replicas / scale) can make the
        # newest snapshot equal the live spec; "restoring" it would no-op
        # inside apply() and silently destroy the revision — skip
        # identical snapshots (apply() re-pushes that state anyway) and
        # roll back to the newest DISTINCT one
        popped = []
        while dep.revisions and dep.revisions[-1] == dep.spec:
            popped.append(dep.revisions.pop())
        if not dep.revisions:
            dep.revisions.extend(reversed(popped))    # history untouched
            _fail("name", f"deployment {name!r} has no previous spec "
                          f"revision differing from the live spec")
        prev = dep.revisions.pop()
        # apply() pushes the current spec as the newest revision, so
        # rollback twice round-trips; the popped snapshot is re-applied
        # as-is (already a deep copy)
        return self.apply(prev)

    def delete(self, name: str) -> bool:
        """Tear the deployment down: scancel every live job (in-flight
        requests fail 462 — delete is not a drain) and cascade-delete the
        backing rows."""
        dep = self.deployments.pop(name, None)
        if dep is None:
            return False
        for job in self._jobs(dep):
            if job["slurm_job_id"] is not None:
                self.slurm.scancel(job["slurm_job_id"])
        self._by_config.pop(dep.config_id, None)
        self.job_worker.managed.discard(dep.config_id)
        if self.db["ai_model_configurations"].get(dep.config_id) is not None:
            self.db["ai_model_configurations"].delete(self.db, dep.config_id)
        if self.gateway is not None:
            self.gateway.set_model_policy(name, None)
            self.gateway.set_model_queue(name, None, None)
        self._emit("DELETED", dep)
        return True

    def patch_replicas(self, config_id: int, delta: int, rule: str = "",
                       pool: Optional[str] = None) -> Optional[tuple]:
        """Autoscaler actuation: patch spec.replicas by ``delta``, clamped
        to the deployment's [min_replicas, max_replicas] window.  Returns
        (old, new) for a managed config — possibly equal when clamped —
        or None when the config is not declaratively managed (the webhook
        then falls back to the legacy DB mutation).

        For disaggregated deployments the patch is pool-addressed: the
        firing rule names ``pool`` (prefill/decode) and the clamp uses that
        pool's own replica window, so the two pools scale independently.
        A pool-less alert (the generic queue rules) grows the decode pool —
        the engine queue it observes is dominated by decode residency."""
        dep = self._by_config.get(config_id)
        if dep is None:
            return None
        dis = dep.spec.disaggregation
        if dis is not None:
            pool = pool or "decode"
            attr = f"{pool}_replicas"
            old = getattr(dis, attr)
            lo, hi = dis.window(pool)
            new = max(lo, min(hi, old + delta))
            if new != old:
                setattr(dis, attr, new)
        else:
            old = dep.spec.replicas
            new = max(dep.spec.min_replicas,
                      min(dep.spec.max_replicas, old + delta))
            if new != old:
                dep.spec.replicas = new
        if new != old:
            dep.generation += 1
            self._emit("SCALED", dep, extra={"rule": rule, "delta": delta,
                                             **({"pool": pool} if dis else {})})
            self._update_status(dep, dep.desired_replicas, self.loop.now)
        return old, new

    # ------------------------------------------------------------------
    # watch plumbing (event dicts; AdminClient wraps them in WatchEvent)
    # ------------------------------------------------------------------
    def watch(self, fn: Callable[[dict], None]) -> Callable:
        self._watchers.append(fn)
        return fn

    def unwatch(self, fn: Callable[[dict], None]):
        if fn in self._watchers:
            self._watchers.remove(fn)

    def _emit(self, etype: str, dep: ModelDeployment,
              extra: Optional[dict] = None):
        event = {"type": etype, "name": dep.name, "t": self.loop.now,
                 "object": dep.to_dict()}
        if extra:
            event.update(extra)
        for fn in list(self._watchers):
            fn(event)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------
    def reconcile(self, now: Optional[float] = None):
        now = self.loop.now if now is None else now
        for dep in list(self.deployments.values()):
            self._reconcile_one(dep, now)

    def _jobs(self, dep: ModelDeployment) -> list:
        jobs = self.db["ai_model_endpoint_jobs"].select(
            configuration_id=dep.config_id)
        return [j for j in jobs
                if self.slurm.job_state(j["slurm_job_id"])
                in (JobState.PENDING, JobState.RUNNING)]

    def _instance_for(self, job: dict):
        eps = self.db["ai_model_endpoints"].select(endpoint_job_id=job["id"])
        if not eps:
            return None
        return self.registry.get(endpoint_key(eps[0]))

    def _wire_gateway(self, dep: ModelDeployment):
        """Push per-deployment routing/queue/disaggregation policy into the
        Web Gateway."""
        if self.gateway is None:
            return
        dis = dep.spec.disaggregation
        if dis is not None:
            # phase-aware two-hop routing; the spec's routing_policy (if
            # any) becomes the within-pool endpoint choice
            self.gateway.set_model_policy(
                dep.name, "disaggregated",
                inner=dep.spec.routing_policy or "least_loaded")
            self.gateway.set_model_disaggregation(dep.name, DisaggProfile(
                transfer_bandwidth=dis.transfer_bandwidth,
                max_retries=dis.max_retries,
                stream_chunks=dis.stream_chunks))
        else:
            self.gateway.set_model_policy(dep.name, dep.spec.routing_policy)
            self.gateway.set_model_disaggregation(dep.name, None)
        self.gateway.set_model_queue(dep.name, dep.spec.queue_capacity,
                                     dep.spec.queue_ttl)

    def _start_drain(self, dep: ModelDeployment, job: dict, now: float):
        dep._draining[job["id"]] = now + dep.spec.drain_grace
        inst = self._instance_for(job)
        if inst is not None:
            inst.drain()

    def _orphans(self, dep: ModelDeployment, jobs: list) -> list:
        """Jobs whose phase belongs to no current pool — left behind by a
        unified<->disaggregated spec transition; they are retired like any
        other scale-down victim."""
        target_phases = {ph for ph, _ in dep.pool_targets()}
        return [j for j in jobs if j.get("phase") not in target_phases]

    def _reconcile_one(self, dep: ModelDeployment, now: float):
        cfg = self.db["ai_model_configurations"].get(dep.config_id)
        if cfg is None:        # deleted out from under us
            return
        desired_total = dep.desired_replicas
        # keep the legacy desired-state column in sync: the spec is the
        # source of truth, the DB row is the executor's actuation record
        if cfg["instances"] != desired_total:
            self.db["ai_model_configurations"].update(
                cfg["id"], instances=desired_total)

        live = self._jobs(dep)
        known = {j["id"] for j in live}
        dep._job_template = {k: v for k, v in dep._job_template.items()
                             if k in known}
        dep._draining = {k: v for k, v in dep._draining.items()
                         if k in known}

        # 1. finish drains: scancel once idle (or past the grace deadline)
        for job in [j for j in live if j["id"] in dep._draining]:
            inst = self._instance_for(job)
            idle = inst is None or not inst.engine.has_work()
            if idle or now >= dep._draining[job["id"]]:
                self.slurm.scancel(job["slurm_job_id"])
                dep._draining.pop(job["id"], None)

        live = self._jobs(dep)     # re-read after cancels
        # phase-pool transitions: retire jobs belonging to no current pool
        for job in self._orphans(dep, [j for j in live
                                       if j["id"] not in dep._draining]):
            if job["ready_at"] is None:
                self.slurm.scancel(job["slurm_job_id"])
            else:
                self._start_drain(dep, job, now)
        live = self._jobs(dep)

        submitted = False          # one submission per tick, the paper's
        for phase, desired in dep.pool_targets():  # Job-Worker pacing
            submitted |= self._reconcile_pool(
                dep, cfg, phase, desired, live, now,
                allow_submit=not submitted)

        self._update_status(dep, desired_total, now)

    def _reconcile_pool(self, dep: ModelDeployment, cfg: dict,
                        phase: Optional[str], desired: int, live: list,
                        now: float, allow_submit: bool) -> bool:
        """Converge one phase pool (the whole deployment for unified
        specs).  Returns True when a job submission was spent."""
        spec = dep.spec
        pool = [j for j in live if j.get("phase") == phase]
        active = [j for j in pool if j["id"] not in dep._draining]
        stale = [j for j in active
                 if dep._job_template.get(j["id"], 0)
                 < dep.template_generation]
        fresh = [j for j in active if j not in stale]

        # 2. scale up / rolling surge: during an update up to `max_surge`
        # replicas may run above the pool target
        surge = spec.max_surge if stale else 0
        if len(fresh) < desired and len(active) < desired + surge:
            if allow_submit:
                row = self.job_worker.submit_one(
                    cfg, now, priority=spec.priority_class, phase=phase)
                dep._job_template[row["id"]] = dep.template_generation
                return True
        elif stale:
            # 3. rolling update: stale replicas that never became ready are
            # not serving — cancel outright; ready stale replicas retire
            # within the availability budget
            for job in [j for j in stale if j["ready_at"] is None]:
                self.slurm.scancel(job["slurm_job_id"])
            ready_stale = sorted((j for j in stale
                                  if j["ready_at"] is not None),
                                 key=lambda j: j["submitted_at"] or 0)
            ready_fresh = [j for j in fresh if j["ready_at"] is not None]
            floor = min(dep.pool_floor(phase), desired)
            ready_total = len(ready_stale) + len(ready_fresh)
            if spec.max_unavailable is None:
                # legacy budget: one retirement per tick, only while a
                # fresh replica is ready and ready count stays >= floor
                if ready_stale and ready_fresh and ready_total - 1 >= floor:
                    self._start_drain(dep, ready_stale[0], now)
            else:
                # k8s budget: ready replicas may drop `max_unavailable`
                # below the target (never below the pool floor), with no
                # fresh-ready precondition — that is what the knob buys
                keep = max(floor, desired - spec.max_unavailable)
                for job in ready_stale[:max(0, ready_total - keep)]:
                    self._start_drain(dep, job, now)
        elif len(active) > desired:
            # 4. scale down: not-yet-ready victims first (nothing to
            # drain), then the newest ready replicas — which DRAIN instead
            # of being scancel'd with requests in flight
            excess = len(active) - desired
            victims = sorted(active,
                             key=lambda j: (j["ready_at"] is not None,
                                            -(j["submitted_at"] or 0)))
            for job in victims[:excess]:
                if job["ready_at"] is None:
                    self.slurm.scancel(job["slurm_job_id"])
                else:
                    self._start_drain(dep, job, now)
        return False

    # ------------------------------------------------------------------
    def _update_status(self, dep: ModelDeployment, desired: int, now: float):
        live = self._jobs(dep)
        draining = [j for j in live if j["id"] in dep._draining]
        active = [j for j in live if j["id"] not in dep._draining]
        stale = [j for j in active
                 if dep._job_template.get(j["id"], 0)
                 < dep.template_generation]
        st = dep.status
        st.replicas = len(live)
        st.ready_replicas = sum(1 for j in active
                                if j["ready_at"] is not None)
        st.pending_replicas = sum(
            1 for j in active
            if self.slurm.job_state(j["slurm_job_id"]) == JobState.PENDING)
        st.starting_replicas = (len(active) - st.ready_replicas
                                - st.pending_replicas)
        st.draining_replicas = len(draining)

        orphans = self._orphans(dep, active)
        pools_converged = all(
            sum(1 for j in active if j.get("phase") == ph) == n
            and sum(1 for j in active
                    if j.get("phase") == ph and j["ready_at"] is not None) == n
            for ph, n in dep.pool_targets())
        converged = (len(active) == desired
                     and st.ready_replicas == desired
                     and pools_converged and not orphans
                     and not stale and not draining)
        rolling = bool(stale) or any(
            dep._job_template.get(j["id"], 0) < dep.template_generation
            for j in draining)
        if converged:
            reason = "AllReplicasReady"
        elif rolling:
            reason = "RollingUpdate"
        elif len(active) > desired or draining:
            reason = "ScalingDown"
        elif dep.generation != st.observed_generation:
            # converging toward a spec we have not met yet
            reason = "ScalingUp"
        else:
            # the observed generation WAS converged and replicas fell
            # underneath us (node failure, job death): the replacement may
            # already be submitted, the reason records why we regressed
            reason = "ReplicaFailure"

        msg = (f"{st.ready_replicas}/{desired} ready "
               f"({st.starting_replicas} starting, "
               f"{st.pending_replicas} pending, "
               f"{st.draining_replicas} draining)")
        flips = []
        if st.set_condition(COND_AVAILABLE,
                            st.ready_replicas >= min(dep.spec.min_replicas,
                                                     desired),
                            "MinimumReplicasAvailable"
                            if st.ready_replicas >= min(dep.spec.min_replicas,
                                                        desired)
                            else "MinimumReplicasUnavailable", msg, now):
            flips.append(COND_AVAILABLE)
        if st.set_condition(COND_READY, converged, reason, msg, now):
            flips.append(COND_READY)
        if st.set_condition(COND_PROGRESSING, not converged, reason, msg,
                            now):
            flips.append(COND_PROGRESSING)
        if converged:
            st.observed_generation = dep.generation
        for ctype in flips:
            cond = st.condition(ctype)
            dep.transitions.append((now, ctype, cond.status, cond.reason))
        if flips:
            self._emit("CONDITION", dep)
