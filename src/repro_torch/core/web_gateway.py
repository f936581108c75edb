"""Web Gateway (paper §3.1.2): OpenAI-compatible entry point.

Responsibilities reproduced: bearer-token authentication against the
encrypted store with a TTL'd distributed memory cache; strong request
validation; endpoint lookup in ai_model_endpoints; forwarding with all
request parameters; custom status codes when no ready endpoint exists.

The wire contract lives in `repro_torch.api` (see docs/api.md): `api_handle`
returns ``(status, TokenStream, APIError | None)`` — the structured-error
mapping of the paper's custom codes (401/422/429/460/461/462) with
``retry_after`` derived from the queue TTL / scale-up cooldown / tenant
token-bucket refill.  Multi-tenant QoS (repro_torch.core.tenancy, docs/
tenancy.md) is enforced here: quota admission answers 429, the gateway
queue drains weighted-fair across tenants, and every admitted request is
metered into the tenant's usage records at terminal close.  Streaming
goes through an explicit `TokenStream` session installed once per request;
each dispatch attempt *rebinds* the per-dispatch state (router finish hook,
response-hop delay) instead of re-wrapping `req.on_token`, so queue
re-dispatch cannot stack callbacks.  `handle` remains the thin int-status
view used inside `core/` and tests.

Endpoint selection is delegated to a pluggable `RoutingPolicy`
(repro_torch.core.router).  With `ServiceConfig.queue_capacity > 0` the gateway
additionally holds would-be-461 requests in a bounded TTL queue and drains
them when the controller brings an instance up; expired entries deliver a
terminal 461 error event on their stream (no caller left hanging on a 202).

Latency accounting (virtual clock): every hop/db trip adds to the request's
client-observed times — this is what the Table-1 "Web Gateway vs vLLM node"
comparison measures.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.api.errors import APIError, error_for_status, validation_error
from repro_torch.api.streaming import TokenStream
from repro_torch.config import ServiceConfig
from repro_torch.core.db import Database
from repro_torch.core.disagg import DisaggProfile, request_phase
from repro_torch.core.kvstore import LinkContentionModel, chunk_plan
from repro_torch.core.router import GatewayQueue, endpoint_key, make_policy
from repro_torch.core.simclock import EventLoop
from repro_torch.engine.request import Request, RequestStatus

# custom HTTP-ish status codes (paper: "custom status codes are returned");
# the OpenAI-style wire mapping is repro_torch.api.errors.ERROR_TABLE
OK = 200
QUEUED = 202                 # held in the gateway queue (queuing enabled)
UNAUTHENTICATED = 401
VALIDATION_FAILED = 422
TENANT_QUOTA_EXCEEDED = 429  # tenant rate limit / concurrency cap hit
MODEL_UNKNOWN = 460          # no configuration for requested model
MODEL_NOT_READY = 461        # configured but no ready endpoint yet
INSTANCE_UNREACHABLE = 462   # endpoint row exists but instance is gone


@dataclass
class GatewayLatency:
    auth_cache_hit: float = 5e-5
    auth_db_trip: float = 1.5e-3
    endpoint_db_trip: float = 8e-4
    forward_hop: float = 2.5e-4       # gateway -> compute node
    response_hop: float = 2.5e-4      # per-token streaming return


@dataclass
class GatewayStats:
    # queue counters live on GatewayQueue (see router_stats()), not here
    requests: int = 0
    rejected_auth: int = 0
    rejected_no_endpoint: int = 0
    rejected_admission: int = 0   # est. service time > queue TTL (461)
    rejected_quota: int = 0       # tenant bucket / inflight cap (429)
    rejected_shed: int = 0        # burn-alert class shedding (461)
    forwarded: int = 0
    handoffs: int = 0             # prefill->decode hops orchestrated
    disagg_retries: int = 0       # transparent re-runs after instance loss
    db_trips: int = 0
    cache_hits: int = 0
    per_status: dict = field(default_factory=dict)


class WebGateway:
    def __init__(self, db: Database, loop: EventLoop, registry: dict,
                 latency: GatewayLatency = None, auth_cache_ttl: float = 60.0,
                 services: Optional[ServiceConfig] = None,
                 load_fn: Optional[Callable[[tuple], dict]] = None,
                 prior_fn: Optional[Callable] = None,
                 service_estimator: Optional[Callable] = None,
                 tenancy=None, tracer=None, telemetry=None):
        self.db = db
        self.loop = loop
        self.registry = registry                  # (node, port) -> instance
        self.lat = latency or GatewayLatency()
        self.auth_cache_ttl = auth_cache_ttl
        self.services = services or ServiceConfig()
        # fn(model_name, req) -> estimated service seconds | None; feeds
        # queue admission control (ServiceConfig.admission_control)
        self.service_estimator = service_estimator
        # repro_torch.core.tenancy.TenancyManager (duck-typed; None = no QoS):
        # quota admission, WFQ weights, usage metering
        self.tenancy = tenancy
        # repro_torch.core.tracing.Tracer (None = tracing off): stamps every
        # request with a span tree; recording never touches the EventLoop
        self.tracer = tracer
        # repro_torch.core.telemetry.TelemetryStore (None = burn telemetry
        # off): while a fast-burn SLO alert fires, `api_handle` sheds
        # lower classes before higher ones (slo_shed_enabled gates it)
        self.telemetry = telemetry
        # api_key -> (tenant row | None, expiry); bounded LRU.  Negative
        # lookups cache too (short TTL) — a client retry-looping a bad key
        # must not buy a full auth_db_trip per attempt
        self._auth_cache: OrderedDict[str, tuple] = OrderedDict()
        # negative keys currently cached, in insertion order (eviction
        # victims); a side index so full-cache eviction is O(1), not a
        # scan — the bad-key flood is exactly the hot path
        self._auth_neg: OrderedDict[str, None] = OrderedDict()
        self.stats = GatewayStats()
        # per-model disaggregation profiles (two-hop prefill/decode routing)
        self._disagg: dict[str, DisaggProfile] = {}
        # per-model shared-NIC link models (repro_torch.core.kvstore): chunked
        # handoffs of one deployment queue on its link's bandwidth
        self._kv_links: dict[str, LinkContentionModel] = {}
        svc = self.services
        self._load_fn = load_fn
        # fn(model, req) -> roofline (ttft, tbt) prior, from the control
        # plane; seeds cost-scoring policies before any observations
        self._prior_fn = prior_fn
        self.router = make_policy(
            svc.routing_policy, load_fn=load_fn, prior_fn=prior_fn,
            **({"replicas": svc.affinity_replicas}
               if svc.routing_policy == "session_affinity" else {}),
            **({"prefix_tokens": svc.prefix_tokens}
               if svc.routing_policy == "prefix_aware" else {}))
        # per-deployment policy overrides (ModelDeploymentSpec.routing_policy)
        self._model_routers: dict[str, object] = {}
        self.queue = GatewayQueue(
            capacity=svc.queue_capacity, ttl=svc.queue_ttl,
            aging=svc.queue_aging, fair_queuing=svc.fair_queuing,
            weight_fn=tenancy.weight if tenancy is not None else None,
            class_fn=tenancy.priority_class if tenancy is not None else None,
            # one service-cost currency: WFQ share and displacement use
            # the same charge the token buckets and usage refunds bill
            cost_fn=tenancy.charge if tenancy is not None else None)
        # entries evicted by weighted admission get a terminal 461 (same
        # wire shape as a queue-full rejection, delivered post-202)
        self.queue.on_displaced = self._on_displaced
        self._queue_task = None
        self._ensure_queue_tick()

    # -- per-deployment policy wiring (Reconciler -> gateway) ----------------
    def _ensure_queue_tick(self):
        if self.queue.enabled and self._queue_task is None:
            self._queue_task = self.loop.every(
                self.services.queue_drain_interval, self._queue_tick)

    def stop(self):
        """Tear down the periodic queue drain/expiry tick."""
        if self._queue_task is not None:
            self._queue_task.stop()
            self._queue_task = None

    def set_model_policy(self, model_name: str,
                         policy_name: Optional[str] = None, **kw):
        """Install (or clear, with None) a routing policy that overrides
        the gateway default for one model's requests.  Re-applying the
        SAME policy is a no-op: the installed router keeps its state
        (LeastLoaded in-flight counters, PrefixAware pin map) — a replicas
        patch must not reset routing history."""
        if policy_name is None:
            self._model_routers.pop(model_name, None)
            return
        installed = self._model_routers.get(model_name)
        if installed is not None and installed.name == policy_name:
            return
        self._model_routers[model_name] = make_policy(
            policy_name, load_fn=self._load_fn, prior_fn=self._prior_fn,
            **kw)

    def set_model_queue(self, model_name: str, capacity=None, ttl=None):
        """Per-deployment gateway-queue knobs (None, None clears)."""
        self.queue.configure_model(model_name, capacity, ttl)
        self._ensure_queue_tick()

    def set_model_disaggregation(self, model_name: str,
                                 profile: Optional[DisaggProfile]):
        """Enable (or, with None, disable) two-hop prefill/decode routing
        for one model: KV transfer cost + transparent instance-loss retry
        knobs.  The phase-aware endpoint choice itself comes from the
        model's `disaggregated` routing policy (set_model_policy)."""
        if profile is None:
            self._disagg.pop(model_name, None)
            self._kv_links.pop(model_name, None)
        else:
            self._disagg[model_name] = profile

    def router_for(self, model_name: str):
        return self._model_routers.get(model_name, self.router)

    # ------------------------------------------------------------------
    def _authenticate(self, api_key: str, now: float):
        """Returns (tenant|None, latency_added).  Positive lookups cache
        for `auth_cache_ttl`, negative ones for the much shorter
        `ServiceConfig.auth_neg_ttl` (a revoked-then-reissued key must not
        stay dead for a minute, but a bad-key retry loop must not buy a DB
        trip per attempt); the cache is a bounded LRU
        (`ServiceConfig.auth_cache_max`) so unique-garbage keys cannot
        grow it without limit."""
        hit = self._auth_cache.get(api_key)
        if hit is not None and hit[1] > now:
            self._auth_cache.move_to_end(api_key)
            self.stats.cache_hits += 1
            return hit[0], self.lat.auth_cache_hit
        self.stats.db_trips += 1
        tenant = self.db.authenticate(api_key)
        ttl = self.auth_cache_ttl if tenant is not None \
            else self.services.auth_neg_ttl
        self._auth_cache[api_key] = (tenant, now + ttl)
        self._auth_cache.move_to_end(api_key)
        if tenant is None:
            self._auth_neg[api_key] = None
            self._auth_neg.move_to_end(api_key)
        else:
            self._auth_neg.pop(api_key, None)
        while len(self._auth_cache) > self.services.auth_cache_max:
            # eviction prefers the oldest NEGATIVE entry, then the LRU
            # tail: a flood of unique bad keys must not flush every
            # legitimate tenant's cached key (cache-thrash would hand the
            # attacker exactly the per-request auth_db_trip load the
            # negative cache exists to prevent).  Never the just-inserted
            # key: a single bad key retry-looping against a cache full of
            # fresh positives must keep ITS negative entry (an LRU
            # positive goes instead), or every retry is a DB trip again.
            victim = next((k for k in self._auth_neg if k != api_key),
                          None)
            if victim is None:
                victim, _ = self._auth_cache.popitem(last=False)
            else:
                del self._auth_cache[victim]
            self._auth_neg.pop(victim, None)
        return tenant, self.lat.auth_db_trip

    def _ready_endpoints(self, model_name: str) -> list[dict]:
        return [ep for ep in self.db["ai_model_endpoints"].select(
            model_name=model_name) if ep["ready_at"] is not None]

    def _has_dispatchable(self, model_name: str) -> bool:
        for ep in self._ready_endpoints(model_name):
            inst = self.registry.get(endpoint_key(ep))
            if inst is not None and inst.alive and not inst.draining:
                return True
        return False

    def _is_draining(self, ep: dict) -> bool:
        inst = self.registry.get(endpoint_key(ep))
        return inst is not None and inst.draining

    def _retry_after(self, model_name: Optional[str] = None) -> float:
        """Retry hint for 461/462: the queue TTL governing `model_name`
        when queuing is enabled for it (a queued twin would be held that
        long — per-deployment overrides included), else the autoscaler's
        scale-up cooldown — the earliest a retry could find new capacity."""
        if model_name is not None:
            cap, ttl = self.queue.limits_for(model_name)
            return ttl if cap > 0 else self.services.retry_after_cooldown
        return self.queue.ttl if self.queue.enabled \
            else self.services.retry_after_cooldown

    # ------------------------------------------------------------------
    def handle(self, api_key: str, model_name: str, req: Request) -> int:
        """Int-status view of `api_handle` (used inside core/ and tests)."""
        return self.api_handle(api_key, model_name, req)[0]

    def api_handle(self, api_key: str, model_name: str, req: Request,
                   kind: str = "chat"
                   ) -> tuple[int, TokenStream, Optional[APIError]]:
        """One inference request.  Returns (status, stream, error):
        200 — forwarded (arrival at the engine = now + gateway latency);
        202 — held in the gateway queue, stream stays open;
        else — terminal: `error` is the structured wire object and the
        stream has been closed with it."""
        now = self.loop.now
        self.stats.requests += 1
        req.metrics.gateway_time = now
        if not req.model:
            req.model = model_name
        stream = TokenStream.ensure(req, model=model_name, kind=kind)

        tr = None
        if self.tracer is not None and req.trace is None:
            tr = self.tracer.begin(req, now)
        if tr is not None:
            tr.annotate(model=model_name, endpoint=kind,
                        slo_class=req.slo_class, priority=req.priority,
                        workflow_id=req.workflow_id,
                        session_id=req.session_id)
            # terminal close rides the stream's done hooks (fires exactly
            # once: finish, queue expiry, displacement, instance death)
            stream.on_done(
                lambda s: self.tracer.finish(s.req, s, self.loop.now))

        try:
            req.sampling.validate()    # strong typing/validation layer
        except ValueError as e:
            err = validation_error(getattr(e, "param", None), str(e))
            return self._reject(VALIDATION_FAILED, stream, err)

        tenant, t_auth = self._authenticate(api_key, now)
        if tr is not None:
            # virtual-latency span: the auth cost is charged into the
            # forward delay, so the span models [arrival, arrival + cost]
            tr.start_span(
                "gateway.auth", now,
                cache_hit=t_auth == self.lat.auth_cache_hit).close(
                now + t_auth,
                status="ok" if tenant is not None else "error")
        if tenant is None:
            self.stats.rejected_auth += 1
            return self._reject(UNAUTHENTICATED, stream,
                                error_for_status(UNAUTHENTICATED))
        # the authenticated tenant rides the request: WFQ bucket key,
        # session-affinity namespace, usage-metering account
        req.tenant = tenant["name"]
        if tr is not None:
            tr.annotate(tenant=req.tenant)

        if not self.db["ai_model_configurations"].select(
                model_name=model_name):
            return self._reject(MODEL_UNKNOWN, stream,
                                error_for_status(MODEL_UNKNOWN))

        # per-class burn shedding BEFORE quota admission (a shed request
        # must not burn the tenant's token budget): while a fast-burn SLO
        # alert fires for this model, lower classes are rejected 461 with
        # the alert's projected recovery as the retry hint — batch first,
        # escalating to standard, never interactive (docs/observability.md)
        if self.telemetry is not None and self.services.slo_shed_enabled:
            shed_after = self.telemetry.should_shed(
                model_name, req.slo_class, now)
            if shed_after is not None:
                self.stats.rejected_shed += 1
                self.telemetry.note_shed(model_name, req.slo_class, now)
                if tr is not None:
                    # mark the trace so the telemetry feed skips it — a
                    # shed-induced "miss" must not sustain the very
                    # alert that shed it
                    tr.annotate(shed=True)
                return self._reject(MODEL_NOT_READY, stream,
                                    error_for_status(
                                        MODEL_NOT_READY,
                                        retry_after=shed_after,
                                        message=f"Shedding {req.slo_class}"
                                        f" load: a fast-burn SLO alert is "
                                        f"firing for {model_name!r}."))

        # quota admission AFTER model validation: a typo'd model name must
        # answer 460 without burning the tenant's token budget
        if self.tenancy is not None:
            quota_err = self.tenancy.admit(tenant["name"], req, now)
            if quota_err is not None:
                self.stats.rejected_quota += 1
                return self._reject(TENANT_QUOTA_EXCEEDED, stream, quota_err)
            # terminal metering: usage records + in-flight release fire
            # exactly once, whether the request finishes, expires in the
            # queue, or dies with its instance
            stream.on_done(lambda s, _t=tenant["name"]:
                           self.tenancy.on_request_done(
                               _t, s.req, self.loop.now,
                               failed=s.error is not None))

        self.stats.db_trips += 1
        status = self._route_and_forward(model_name, req, t_auth=t_auth)
        if status in (MODEL_NOT_READY, INSTANCE_UNREACHABLE):
            admission_err = self._admission_check(model_name, req)
            if admission_err is not None:
                self.stats.rejected_admission += 1
                return self._reject(MODEL_NOT_READY, stream, admission_err)
            if self.queue.offer(
                    req, model_name, now,
                    # drained re-dispatches already authenticated at
                    # admission: t_auth=0.0, or every drain pass would
                    # charge auth_cache_hit a second time
                    dispatch=lambda r: self._route_and_forward(
                        model_name, r, t_auth=0.0)):
                if tr is not None:
                    # WFQ/TTL hold: closed by _forward on drain-dispatch,
                    # or force-closed (error) when the entry expires or is
                    # displaced and the stream fails terminally
                    tr.start_span("gateway.queue", now,
                                  phase=request_phase(req))
                return self._status(QUEUED), stream, None
            self.stats.rejected_no_endpoint += 1
        if status != OK:
            return self._reject(status, stream, error_for_status(
                status, retry_after=self._retry_after(model_name)))
        return self._status(OK), stream, None

    def _reject(self, status: int, stream: TokenStream, err: APIError
                ) -> tuple[int, TokenStream, APIError]:
        stream.fail(err)
        return self._status(status), stream, err

    def _admission_check(self, model_name: str,
                         req: Request) -> Optional[APIError]:
        """Queue admission by estimated service time: a request whose
        roofline-estimated service time exceeds the queue TTL it would be
        held under cannot be served within its budget — answer 461 now
        (with the TTL as the retry hint) instead of parking it."""
        if not self.services.admission_control \
                or self.service_estimator is None:
            return None
        cap, ttl = self.queue.limits_for(model_name)
        if cap <= 0:                    # no queue -> nothing to admit into
            return None
        est = self.service_estimator(model_name, req)
        if est is None or est <= ttl:
            return None
        return error_for_status(
            MODEL_NOT_READY, retry_after=ttl,
            message=f"Admission rejected: estimated service time "
                    f"{est:.1f}s exceeds the {ttl:.0f}s queue TTL.")

    def _route_and_forward(self, model_name: str, req: Request,
                           t_auth: Optional[float] = None) -> int:
        """Policy selection + forward. Returns OK / MODEL_NOT_READY /
        INSTANCE_UNREACHABLE without recording per-status stats (the caller
        decides whether the request instead enters the queue)."""
        eps = self._ready_endpoints(model_name)
        if not eps:
            return MODEL_NOT_READY
        # draining replicas finish their in-flight work but take no new
        # traffic (declarative scale-down / rolling update); with every
        # ready endpoint draining the request queues like a 461 would
        eps = [e for e in eps if not self._is_draining(e)]
        if not eps:
            return MODEL_NOT_READY
        # drop zombie rows (endpoint row exists, instance dead/unregistered)
        # BEFORE the policy sees the list: a second select() on a filtered
        # list would advance RoundRobin's cursor twice (silently skipping an
        # endpoint per zombie hit) and make PrefixAware pin the prefix to
        # the dead endpoint's key before re-pinning
        live = [e for e in eps
                if (i := self.registry.get(endpoint_key(e))) is not None
                and i.alive]
        if not live:
            return INSTANCE_UNREACHABLE
        router = self.router_for(model_name)
        ep = router.select(live, req)
        inst = self.registry[endpoint_key(ep)]
        self._forward(ep, inst, req,
                      t_auth if t_auth is not None else self.lat.auth_cache_hit,
                      router=router)
        return OK

    def _forward(self, ep: dict, inst, req: Request, t_auth: float,
                 router=None):
        router = router if router is not None else self.router
        now = self.loop.now
        delay = t_auth + self.lat.endpoint_db_trip + self.lat.forward_hop
        key = endpoint_key(ep)
        stream = TokenStream.ensure(req)
        if req.trace is not None:
            # a queued request's WFQ wait ends at this dispatch (no-op for
            # the direct-forward path, where no gateway.queue span is open)
            req.trace.close_span("gateway.queue", now)
            # one router.select span per dispatch attempt: a disaggregated
            # request gets two (hop attr), a transparent retry more, and a
            # fallback-to-unified shows up as phase="unified" on the
            # endpoint it actually landed on
            req.trace.start_span(
                "router.select", now,
                endpoint=f"{key[0]}:{key[1]}", policy=router.name,
                phase=ep.get("phase") or "unified",
                hop=request_phase(req),
                retry=req.disagg_retries).close(now + delay)
        # rebind (never wrap): response streaming adds the return hop to
        # client-side timestamps, and the finish hook releases this
        # dispatch's endpoint slot in the router
        epoch = stream.bind(
            finish_hook=lambda r: router.note_finish(key, r),
            transport_delay=self.lat.response_hop)
        stream.retry_after_hint = self._retry_after(ep["model_name"])
        router.note_dispatch(ep, req)

        def submit():
            if inst.submit(req, bearer=ep["bearer_token"]) != 200:
                # the instance died during the forward hop: deliver a
                # terminal error instead of losing the request silently
                # (ignored if a newer dispatch took over — stale epoch);
                # fail() fires the finish hook, releasing the router slot
                if stream.fail(error_for_status(
                        INSTANCE_UNREACHABLE,
                        retry_after=self._retry_after(ep["model_name"])),
                        epoch=epoch):
                    req.status = RequestStatus.FAILED

        self.loop.call_after(delay, submit)
        self.stats.forwarded += 1

    # -- disaggregated prefill/decode (repro_torch.core.disagg) ---------------
    def _kv_link(self, model_name: str,
                 prof: DisaggProfile) -> LinkContentionModel:
        """One shared-NIC link per deployment: every handoff of the model
        queues its chunks on this link's bandwidth (recreated when the
        profile's ``transfer_bandwidth`` knob changes)."""
        link = self._kv_links.get(model_name)
        if link is None or link.bandwidth != prof.transfer_bandwidth:
            link = LinkContentionModel(prof.transfer_bandwidth)
            self._kv_links[model_name] = link
        return link

    def on_prefill_handoff(self, req: Request, handoff, now: float = None):
        """Wired as the prefill-only engines' ``on_handoff``: the prefill
        hop produced the first token and exported its sealed KV blocks.
        The payload streams in ``prof.stream_chunks`` chunks through the
        model's shared-NIC `LinkContentionModel`: the decode hop
        dispatches once the FIRST chunk lands (instead of waiting for the
        whole payload, the old atomic model's TBT-tail cost) and each
        later chunk is only reserved on the link after the previous one
        completes, so simultaneous handoffs interleave and queue on
        bandwidth honestly instead of each assuming the full
        ``transfer_bandwidth``.  ``stream_chunks=1`` reproduces the
        atomic behaviour (benchmarks/kvstore.py uses it as baseline)."""
        now = self.loop.now if now is None else now
        prof = self._disagg.get(req.model) or DisaggProfile(
            transfer_bandwidth=self.services.kv_transfer_bandwidth)
        link = self._kv_link(req.model, prof)
        self.stats.handoffs += 1
        # the prefill endpoint's router slot is free as of now; the decode
        # hop rebinds the stream (new dispatch epoch) when it forwards
        stream = TokenStream.ensure(req)
        stream.release_dispatch()
        model = req.model
        sizes = chunk_plan(handoff.kv_bytes, prof.stream_chunks)
        trace = req.trace

        def send(i: int):
            t0 = self.loop.now
            if trace is not None and i == 0:
                # parent for the per-chunk children, anchored at the first
                # link reservation (loop time — the engine's `now` is the
                # virtual t_done, which the link model does not use);
                # closed when the last chunk lands, or force-closed if the
                # stream dies mid-transfer
                trace.start_span("kv.handoff", t0, bytes=handoff.kv_bytes,
                                 chunks=len(sizes))
            done = link.transmit(sizes[i], t0)
            # per-chunk charge (incl. link queueing): chunks of one
            # handoff are back-to-back, so the sum is the true span —
            # exactly the old atomic charge when the link is idle
            req.metrics.kv_transfer_time += done - t0
            if trace is not None:
                par = trace.open_span("kv.handoff")
                # link_wait = time queued behind other handoffs on the
                # shared NIC, beyond the chunk's own serialisation time
                trace.start_span(
                    "kv.handoff.chunk", t0, parent=par, chunk=i,
                    bytes=sizes[i],
                    link_wait=(done - t0) - sizes[i] / link.bandwidth
                    ).close(done)
                if i + 1 == len(sizes) and par is not None:
                    par.close(done)
            if i == 0:
                def dispatch_decode():
                    # the transfer window can outlive the request (queue-
                    # TTL expiry, fair-share displacement): a terminally
                    # closed stream must not be re-dispatched as a zombie
                    # decode hop
                    if not stream.closed:
                        self._redispatch(model, req)

                self.loop.call_after(max(0.0, done - t0), dispatch_decode)
            if i + 1 < len(sizes):
                def next_chunk():
                    # a closed stream abandons its tail chunks, so a dead
                    # request stops reserving link bandwidth
                    if not stream.closed:
                        send(i + 1)

                self.loop.call_after(max(0.0, done - t0), next_chunk)

        send(0)

    def on_instance_lost(self, req: Request) -> bool:
        """Wired as every instance's ``lost_sink``: an instance died with
        this request in flight.  For disaggregation-managed models the
        gateway re-runs the request from the prefill hop (the KV died with
        the instance) instead of failing the stream — budgeted by the
        profile's ``max_retries``; the gateway queue + reconciler cover the
        window until a replacement pool member is up.  Returns True when
        the request was taken over."""
        prof = self._disagg.get(req.model)
        if prof is None or req.disagg_retries >= prof.max_retries:
            return False
        req.disagg_retries += 1
        req.handoff = None              # the prefilled KV is gone
        req.output_tokens = []          # restart-from-scratch (RECOMPUTE)
        # full restart: the retry's tokens are THE completion — drop the
        # pre-crash events from the stream and let the engine re-stamp
        # first-token time, so neither the terminal response nor the
        # engine-side ttft/e2el mixes the two runs
        req.metrics.first_token_time = None
        if req.trace is not None:
            # close every open span as errored: the re-run's spans appear
            # as SIBLINGS next to the interrupted attempt's, so the lost
            # hop stays visible instead of vanishing
            req.trace.interrupt(self.loop.now, "instance_lost")
            req.trace.annotate(retries=req.disagg_retries)
        TokenStream.ensure(req).restart()
        self.stats.disagg_retries += 1
        model = req.model
        stream = TokenStream.ensure(req)

        def dispatch_retry():
            # same-tick queue expiry/displacement can terminally close the
            # stream before this deferred retry fires; don't resurrect it
            if not stream.closed:
                self._redispatch(model, req)

        # deferred: kill() is still iterating the dying engine's queues
        self.loop.call_after(0.0, dispatch_retry)
        return True

    def _redispatch(self, model_name: str, req: Request):
        """Dispatch a follow-up hop (decode hop / transparent retry).  No
        HTTP response is held open for these, so a terminal failure must be
        delivered as an error event on the stream; MODEL_NOT_READY /
        INSTANCE_UNREACHABLE re-enqueue into the gateway queue first.
        Follow-up hops authenticated at original admission: t_auth=0.0."""
        status = self._route_and_forward(model_name, req, t_auth=0.0)
        if status == OK:
            return
        if self.queue.offer(
                req, model_name, self.loop.now,
                dispatch=lambda r: self._route_and_forward(
                    model_name, r, t_auth=0.0)):
            if req.trace is not None:
                req.trace.start_span("gateway.queue", self.loop.now,
                                     phase=request_phase(req))
            return
        req.status = RequestStatus.FAILED
        self.stats.rejected_no_endpoint += 1
        self._status(status)
        TokenStream.ensure(req).fail(error_for_status(
            status, retry_after=self._retry_after(model_name)))

    # -- router-side queue --------------------------------------------------
    def _on_displaced(self, item):
        """A queued entry was evicted by fair-share admission (the queue
        was full and an under-share tenant's request took its slot):
        deliver the terminal 461 its 202 promised."""
        item.req.status = RequestStatus.FAILED
        self.stats.rejected_no_endpoint += 1
        self._status(MODEL_NOT_READY)
        TokenStream.ensure(item.req).fail(error_for_status(
            MODEL_NOT_READY,
            retry_after=self._retry_after(item.model_name),
            message="Displaced from the full gateway queue by fair-share "
                    "admission (an under-share tenant's request took the "
                    "slot)."))

    def notify_ready(self, model_name: str):
        """Called by the Endpoint Worker when an instance becomes ready:
        drain queued requests for that model immediately."""
        if self.queue.enabled:
            self._drain(model_name)

    def _queue_tick(self, now: float = None):
        now = self.loop.now if now is None else now
        for item in self.queue.expire(now):
            # TTL exceeded: answer with the paper's 461 after the fact —
            # a terminal error event on the stream, so no caller that got
            # a 202 is left hanging forever
            item.req.status = RequestStatus.FAILED
            self.stats.rejected_no_endpoint += 1
            self._status(MODEL_NOT_READY)
            held = item.deadline - item.enqueued_at   # the TTL that applied
            TokenStream.ensure(item.req).fail(error_for_status(
                MODEL_NOT_READY,
                retry_after=self._retry_after(item.model_name),
                message=f"Request expired after {held:.0f}s in the "
                        f"gateway queue with no endpoint ready."))
        for model_name in self.queue.models():
            self._drain(model_name)

    def _drain(self, model_name: str):
        self.queue.drain(model_name, self.loop.now,
                         can_dispatch=self._has_dispatchable)

    # ------------------------------------------------------------------
    def router_stats(self) -> dict:
        out = self.router.stats()
        out["queue"] = self.queue.stats()
        if self._model_routers:
            out["per_model"] = {name: r.stats()
                                for name, r in self._model_routers.items()}
        if self._kv_links:
            out["kv_links"] = {name: link.stats()
                               for name, link in self._kv_links.items()}
        return out

    def _status(self, code: int) -> int:
        self.stats.per_status[code] = self.stats.per_status.get(code, 0) + 1
        return code
