"""Control-plane assembly: the full two-layer architecture of the paper.

Layer 1 (Kubernetes microservices): Web Gateway, Job Worker, Slurm Submit,
Endpoint Gateway, Endpoint Worker, Metrics Gateway, Autoscaler, central DB.
Layer 2 (Slurm jobs): vLLM engine instances spawned on simulated HPC nodes.

The engine executor is injectable: SimExecutor (roofline timing, used by the
Table-1 benchmarks) or RealExecutor (actual PyTorch compute, used in tests and
examples with reduced configs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.config import (GPU_H100, HardwareConfig, ModelConfig,
                          ServiceConfig)
from repro_torch.core.autoscaler import Autoscaler, AlertRule, rule_from_dict
from repro_torch.core.db import Database
from repro_torch.core.deployments import Reconciler
from repro_torch.core.instance import VLLMInstance
from repro_torch.core.kvstore import TierCache, make_tier_store
from repro_torch.core.metrics_gateway import MetricsGateway
from repro_torch.core.services import (EndpointGateway, EndpointWorker,
                                       JobWorker, SlurmSubmit)
from repro_torch.core.simclock import EventLoop, TracingEventLoop
from repro_torch.core.slurm import SimNode, SimSlurm
from repro_torch.core.telemetry import TelemetryStore
from repro_torch.core.tenancy import TenancyManager, TenantSpec
from repro_torch.core.tracing import Tracer
from repro_torch.core.web_gateway import WebGateway
from repro_torch.engine.engine import LLMEngine
from repro_torch.engine.executor import SimExecutor


@dataclass
class ClusterSpec:
    num_nodes: int = 8
    gpus_per_node: int = 4
    partition: str = "gpu"
    hardware: HardwareConfig = GPU_H100
    # service cycle times
    job_worker_interval: float = 15.0     # paper: every 15 seconds
    endpoint_worker_interval: float = 5.0
    scrape_interval: float = 5.0
    autoscaler_interval: float = 10.0
    startup_timeout: float = 1800.0       # paper: 30 minutes
    slurm_sched_interval: float = 2.0
    reconcile_interval: float = 5.0       # declarative-deployment loop
    # engine shape
    num_blocks: int = 4096
    block_size: int = 32
    max_num_seqs: int = 64
    max_prefill_tokens: int = 2048
    max_model_len: int = 8192
    max_instances: int = 8
    # gateway routing policy + router-side queuing knobs
    services: ServiceConfig = field(default_factory=ServiceConfig)
    # sanitizer mode: run the plane on a TracingEventLoop (trace digest for
    # two-run determinism checks + tie-order/re-entrancy/heap diagnostics)
    sanitize: bool = False


class ControlPlane:
    def __init__(self, spec: ClusterSpec = None,
                 engine_factory: Optional[Callable] = None,
                 alert_rules: Optional[list[AlertRule]] = None):
        self.spec = spec or ClusterSpec()
        self.loop = TracingEventLoop() if self.spec.sanitize else EventLoop()
        self.db = Database()
        self.registry: dict[tuple, VLLMInstance] = {}
        self.model_cfgs: dict[str, ModelConfig] = {}
        self.instances_spawned: list[VLLMInstance] = []
        self._engine_factory = engine_factory or self._default_engine

        nodes = [SimNode(f"node{i:03d}", gpus=self.spec.gpus_per_node,
                         partition=self.spec.partition)
                 for i in range(self.spec.num_nodes)]
        self.slurm = SimSlurm(self.loop, nodes,
                              sched_interval=self.spec.slurm_sched_interval)
        self.endpoint_gateway = EndpointGateway(self.db, self.loop)
        self.slurm_submit = SlurmSubmit(self.slurm, self._job_payload)
        self.job_worker = JobWorker(self.db, self.loop, self.slurm,
                                    self.slurm_submit,
                                    interval=self.spec.job_worker_interval)
        self.endpoint_worker = EndpointWorker(
            self.db, self.loop, self.slurm, self.registry,
            interval=self.spec.endpoint_worker_interval,
            startup_timeout=self.spec.startup_timeout)
        self.metrics_gateway = MetricsGateway(
            self.db, self.loop, self.registry,
            scrape_interval=self.spec.scrape_interval,
            max_instances=self.spec.max_instances)
        self.autoscaler = Autoscaler(self.metrics_gateway, self.loop,
                                     rules=alert_rules,
                                     eval_interval=self.spec.autoscaler_interval)
        # multi-tenant QoS: specs/buckets/usage metering over the DB; the
        # gateway enforces (429 + WFQ weights), the scrape reports
        self.tenancy = TenancyManager(self.db, self.loop)
        # distributed request tracing: the gateway stamps/closes span
        # trees, the scrape folds per-span-kind histograms (knobs live on
        # ServiceConfig — tracing_enabled, sample rates, retention bound)
        self.tracer = Tracer(self.spec.services)
        # SLO burn-rate telemetry: fed per-request by the tracer (so it
        # goes dark when tracing is off), evaluated by the scrape, read
        # by the gateway's class shedding and SLO_BURN_SCALE_UP
        svc = self.spec.services
        self.telemetry = TelemetryStore(svc) \
            if svc.telemetry_enabled and svc.tracing_enabled else None
        self.tracer.telemetry = self.telemetry
        self.web_gateway = WebGateway(
            self.db, self.loop, self.registry,
            services=self.spec.services,
            load_fn=self.metrics_gateway.endpoint_load,
            prior_fn=self.roofline_prior,
            service_estimator=self.estimate_service_time,
            tenancy=self.tenancy, tracer=self.tracer,
            telemetry=self.telemetry)
        self._cost_cache: dict[str, object] = {}
        # queued gateway demand feeds the scrape; fresh endpoints drain it
        self.metrics_gateway.attach_web_gateway(self.web_gateway)
        self.metrics_gateway.tenancy = self.tenancy
        self.metrics_gateway.tracer = self.tracer
        self.metrics_gateway.telemetry = self.telemetry
        self.endpoint_worker.on_ready = self.web_gateway.notify_ready
        # declarative layer: ModelDeployment specs reconciled on the loop;
        # the Job Worker is its executor, the autoscaler its spec patcher
        self.reconciler = Reconciler(
            self.db, self.loop, self.slurm, self.job_worker, self.registry,
            interval=self.spec.reconcile_interval, gateway=self.web_gateway,
            default_max_model_len=self.spec.max_model_len,
            known_models=lambda m: m in self.model_cfgs)
        self.metrics_gateway.spec_patcher = self.reconciler.patch_replicas
        # per-deployment observability overrides (ModelDeploymentSpec
        # prometheus_labels / alert_rules) resolved through the reconciler
        self.metrics_gateway.deployment_labels = self._deployment_labels
        self.autoscaler.rules_for = self._alert_rules_for
        self.autoscaler.pool_hint = self._burning_pool
        # cluster-wide shared KV store tier, one per model: every replica's
        # TieredKVStore writes through to it, so a prefix demoted on one
        # instance is promotable on another (hierarchical KV, paper §KV)
        self.shared_kv: dict[str, TierCache] = {}

    # ------------------------------------------------------------------
    def add_tenant(self, name: str, api_key: str,
                   spec: Optional[TenantSpec] = None):
        """Create the tenant's auth row; an optional `TenantSpec` attaches
        its QoS policy in the same call (equivalent to a follow-up
        `AdminClient.apply_tenant`)."""
        row = self.db.create_tenant(name, api_key)
        if spec is not None:
            self.tenancy.apply(spec)
        return row

    def register_model(self, cfg: ModelConfig) -> ModelConfig:
        """Make an engine `ModelConfig` known to the plane without creating
        any desired state — the declarative path: `register_model` then
        `AdminClient.apply(ModelDeploymentSpec(...))`."""
        self.model_cfgs[cfg.name] = cfg
        return cfg

    def add_model(self, cfg: ModelConfig, *, instances: int = 1,
                  gpus_per_node: int = 1, nodes: int = 1,
                  est_load_time: float = 120.0, version: str = "1",
                  max_model_len: Optional[int] = None) -> dict:
        """Legacy imperative path: insert the configuration row directly
        (the Job Worker's count-diffing loop converges it).  New callers
        should prefer `register_model` + a ModelDeploymentSpec."""
        self.model_cfgs[cfg.name] = cfg
        return self.db["ai_model_configurations"].insert(
            self.db, model_name=cfg.name, model_version=version,
            instances=instances, gpus_per_node=gpus_per_node, nodes=nodes,
            est_load_time=est_load_time,
            max_model_len=max_model_len or self.spec.max_model_len,
            slurm_partition=self.spec.partition)

    # ------------------------------------------------------------------
    def _deployment_labels(self, model_name: str) -> Optional[dict]:
        """Per-deployment extra Prometheus target labels
        (`ModelDeploymentSpec.prometheus_labels`); None for models not
        under declarative management."""
        dep = self.reconciler.deployments.get(model_name)
        if dep is None:
            return None
        return dep.spec.prometheus_labels

    def _alert_rules_for(self, config_id) -> Optional[list[AlertRule]]:
        """Per-deployment alert-rule overrides
        (`ModelDeploymentSpec.alert_rules`); None falls back to the
        autoscaler's global rule set."""
        dep = self.reconciler._by_config.get(config_id)
        if dep is None or dep.spec.alert_rules is None:
            return None
        return [rule_from_dict(r) for r in dep.spec.alert_rules]

    def _burning_pool(self, config_id) -> Optional[str]:
        """Resolve SLO_BURN_SCALE_UP's ``pool="burning"`` sentinel: the
        pool the model's firing burn alert blames, or None (= plain
        replica count) for unified deployments — a decode-pool patch on
        a deployment with no pools would be a misdirected write."""
        if self.telemetry is None:
            return None
        cfg = self.db["ai_model_configurations"].get(config_id)
        if cfg is None:
            return None
        pool = self.telemetry.burning_pool(cfg["model_name"])
        if pool is None:
            return None
        dep = self.reconciler.deployments.get(cfg["model_name"])
        if dep is None or dep.spec.disaggregation is None:
            return None
        return pool

    def _tier_store_for(self, model_name: str):
        """Build one engine's lower KV tiers from the deployment's
        `KVStoreSpec`: a private host-DRAM tier plus the model's
        cluster-wide shared tier (lazily created here, then reused by
        every replica of the model).  None when tiering is off."""
        dep = self.reconciler.deployments.get(model_name)
        kspec = dep.spec.kv_store if dep is not None else None
        if kspec is None:
            return None
        shared = None
        if kspec.shared_blocks > 0:
            shared = self.shared_kv.get(model_name)
            if shared is None:
                shared = self.shared_kv[model_name] = TierCache(
                    kspec.shared_blocks, name="shared")
        return make_tier_store(kspec, shared)

    # ------------------------------------------------------------------
    def _roofline(self, model_name: str):
        """Cached RooflineCost for one model at its configured
        tensor-parallel degree (gpus_per_node), matching the engines the
        request would actually run on; None for unknown models."""
        cfg = self.model_cfgs.get(model_name)
        if cfg is None:
            return None
        rows = self.db["ai_model_configurations"].select(
            model_name=model_name)
        tp = int(rows[0]["gpus_per_node"]) if rows else 1
        cost = self._cost_cache.get((model_name, tp))
        if cost is None:
            from repro_torch.engine.costmodel import RooflineCost
            cost = self._cost_cache[(model_name, tp)] = RooflineCost(
                cfg, self.spec.hardware, tp=tp)
        return cost

    def estimate_service_time(self, model_name: str, req) -> Optional[float]:
        """Roofline service-time estimate (prefill + full decode) for one
        request — the gateway's queue-admission signal."""
        cost = self._roofline(model_name)
        if cost is None:
            return None
        n, out = req.prompt_len, req.target_len()
        return cost.prefill_time(n, n) + out * cost.decode_time(1, n + out)

    def roofline_prior(self, model_name: str, req) -> Optional[tuple]:
        """(ttft_s, tbt_s) roofline prior for one request on an IDLE
        reference instance — the SLO-cost router's cold-start estimate
        before an endpoint has observed finishes."""
        cost = self._roofline(model_name)
        if cost is None:
            return None
        n = req.prompt_len
        return (cost.prefill_time(n, n),
                cost.decode_time(1, n + req.target_len()))

    # ------------------------------------------------------------------
    def _default_engine(self, cfg: ModelConfig, tp: int) -> LLMEngine:
        ex = SimExecutor(cfg, self.spec.hardware, tp=tp)
        return LLMEngine(cfg, ex, num_blocks=self.spec.num_blocks,
                         block_size=self.spec.block_size,
                         max_num_seqs=self.spec.max_num_seqs,
                         max_prefill_tokens=self.spec.max_prefill_tokens,
                         max_model_len=self.spec.max_model_len)

    def _job_payload(self, job, node, params: dict):
        """The .slurm script body: register with the Endpoint Gateway (curl
        POST), then start the vLLM server on the assigned port."""
        phase = params.get("phase") or None   # prefill | decode | None
        port = self.endpoint_gateway.register(
            endpoint_job_id=int(params["endpoint_job_id"]),
            slurm_job_id=job.job_id, node=node.node_id,
            model_name=params["model"], model_version=params["version"],
            bearer_token=params["bearer"], auth="eg", phase=phase)
        if port is None:
            return lambda: None
        cfg = self.model_cfgs[params["model"]]
        engine = self._engine_factory(cfg, int(params.get("gpus", 1)))
        # hierarchical KV: hang the host+shared tiers off the allocator so
        # eviction demotes and match_prefix misses promote (default off —
        # the legacy add_model path has no deployment spec, hence no tiers)
        engine.allocator.tier_store = self._tier_store_for(params["model"])
        if phase is not None:
            # pool member: specialise the engine and wire the prefill
            # handoff back into the gateway's two-hop path
            engine.set_phase(f"{phase}_only")
            if phase == "prefill":
                engine.on_handoff = self.web_gateway.on_prefill_handoff
        inst = VLLMInstance(self.loop, engine, node=node.node_id, port=port,
                            bearer_token=params["bearer"],
                            model_name=cfg.name,
                            load_time=float(params.get("load", 120.0)),
                            phase=phase or "unified")
        inst.lost_sink = self.web_gateway.on_instance_lost
        self.registry[(node.node_id, port)] = inst
        self.instances_spawned.append(inst)

        def kill():
            inst.kill()
            self.registry.pop((node.node_id, port), None)

        return kill

    # ------------------------------------------------------------------
    def shutdown(self):
        """Stop every periodic service tick (scrape, autoscaler, reconcile,
        worker loops, Slurm scheduling, gateway queue drain).  Pending
        one-shot events still run if the loop is pumped further; no NEW
        periodic events are ever scheduled after this returns."""
        for svc in (self.reconciler, self.autoscaler, self.metrics_gateway,
                    self.job_worker, self.endpoint_worker, self.slurm,
                    self.web_gateway):
            svc.stop()

    def run_until(self, t: float):
        self.loop.run_until(t)

    def ready_endpoints(self, model_name: str) -> list[dict]:
        return [ep for ep in self.db["ai_model_endpoints"].select(
            model_name=model_name) if ep["ready_at"] is not None]
