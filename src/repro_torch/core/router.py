"""Pluggable gateway routing & load balancing (paper §3.1.2 extended).

The paper's Web Gateway forwards each request to "a ready endpoint" without
specifying a selection policy; the reference deployment uses a single
round-robin cursor. This module extracts that decision into a
`RoutingPolicy` interface with four implementations, mirroring the routing
modes of the vLLM *production-stack* router proposals (see PAPERS.md):

* `RoundRobin`       — the paper/seed behaviour; fair cursor over ready
                       endpoints sorted by id (production-stack `roundrobin`).
* `LeastLoaded`      — picks the endpoint with the lowest effective queue
                       depth: the `num_waiting + num_running` reported by the
                       last Metrics-Gateway scrape (§3.2.5) plus the requests
                       this gateway has dispatched there since that scrape,
                       tie-broken by KV-cache utilisation
                       (production-stack `load_balancing_router` /
                       TimeTrackingRouter proposals).
* `SessionAffinity`  — consistent hashing on a session/tenant key so every
                       turn of a multi-turn chat lands on the same instance
                       and hits a warm KV cache (production-stack `session`
                       routing; *Chat AI*, arXiv 2407.00110, pins sessions
                       the same way).
* `PrefixAware`      — routes requests that share a prompt prefix (first KV
                       block) to the same instance so vLLM's prefix cache
                       (on by default since v0.10) converts shared chat
                       templates into block hits (production-stack
                       `prefixaware` routing).

It also provides `GatewayQueue`: bounded router-side request queuing with a
TTL (production-stack `router-side-request-queuing` proposal). Instead of
immediately answering 461 when a model has no ready endpoint, the gateway
may hold requests and drain them when the controller brings an instance up;
the queue depth and the age of its head are exported to the Metrics Gateway
so queued requests count toward the autoscaler's scale-up signal (§3.3).
Draining is *weighted fair* across tenants (repro_torch.core.tenancy):
per-tenant buckets under a virtual-time scheduler whose service is measured in tokens,
so one tenant's bulk batch cannot starve another's interactive traffic.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.config import SLO_CLASSES
from repro_torch.engine.request import Request

#: dequeue urgency of each SLO class (higher first): interactive > standard
#: > batch — a latency-target tier outranks per-request priority ints,
#: which order within a class
_SLO_RANK = {c: i for i, c in enumerate(reversed(SLO_CLASSES))}


def _stable_hash(key: str) -> int:
    """Deterministic 64-bit hash (Python's builtin hash is salted)."""
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(),
                          "big")


def endpoint_key(ep: dict) -> tuple:
    return (ep["node"], ep["port"])


# ---------------------------------------------------------------------------
# policy interface
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Selects one ready endpoint row for a request.

    `select` receives the ready endpoint rows (non-empty) for the requested
    model. Policies may keep per-endpoint state; `note_dispatch` /
    `note_finish` bracket each forwarded request so load-aware policies can
    track in-flight work between Metrics-Gateway scrapes.
    """

    name = "abstract"
    # policies that consume Metrics-Gateway scrape snapshots get the
    # gateway's `load_fn` injected by `make_policy`
    wants_load_fn = False
    # policies that seed service-time estimates from the control plane's
    # roofline cost model get `prior_fn(model, req) -> (ttft_s, tbt_s)`
    wants_prior_fn = False

    def __init__(self):
        self.picks: dict[tuple, int] = {}

    def select(self, eps: list[dict], req: Request) -> dict:
        raise NotImplementedError

    def note_dispatch(self, ep: dict, req: Request):
        self.picks[endpoint_key(ep)] = self.picks.get(endpoint_key(ep), 0) + 1

    def note_finish(self, ep_key: tuple, req: Request):
        pass

    def stats(self) -> dict:
        return {"policy": self.name,
                "picks": {f"{n}:{p}": c for (n, p), c in self.picks.items()}}


class RoundRobin(RoutingPolicy):
    """Seed behaviour: fair cursor over endpoints sorted by row id."""

    name = "round_robin"

    def __init__(self):
        super().__init__()
        self._cursor = itertools.count()

    def select(self, eps: list[dict], req: Request) -> dict:
        eps = sorted(eps, key=lambda e: e["id"])
        return eps[next(self._cursor) % len(eps)]


class LeastLoaded(RoutingPolicy):
    """Route to the endpoint with the smallest effective queue depth.

    Effective depth = (num_waiting + num_running from the latest scrape)
    + requests dispatched by this gateway since that scrape. The correction
    term matters: scrapes run every ~5 s, and at 1000 concurrent requests a
    stale scrape would send the whole burst to whichever instance looked
    empty last scrape (the herd effect the production-stack proposal calls
    out). Ties break on scraped KV utilisation, then row id.
    """

    name = "least_loaded"
    wants_load_fn = True

    def __init__(self, load_fn: Optional[Callable[[tuple], dict]] = None):
        super().__init__()
        # (node, port) -> scrape snapshot dict; injected by the gateway
        self.load_fn = load_fn or (lambda key: {})
        self._inflight: dict[tuple, int] = {}
        self._since_scrape: dict[tuple, int] = {}
        self._fin_since_scrape: dict[tuple, int] = {}
        self._scrape_time: dict[tuple, float] = {}

    def _depth(self, ep: dict) -> tuple:
        return (self.effective_depth(ep),
                (self.load_fn(endpoint_key(ep)) or {})
                .get("kv_utilization", 0.0), ep["id"])

    def effective_depth(self, ep: dict) -> int:
        """Scraped depth corrected by this gateway's own traffic since the
        scrape: dispatches add, finishes subtract — both directions, or a
        fast endpoint whose requests complete between ~5 s scrapes would
        look permanently loaded and the policy would herd onto slower ones
        (the exact effect the correction term exists to prevent)."""
        key = endpoint_key(ep)
        snap = self.load_fn(key) or {}
        scraped = snap.get("num_waiting", 0) + snap.get("num_running", 0)
        t = snap.get("time")
        if t is None:
            # never scraped: the gateway's own in-flight count is all we have
            pending = self._inflight.get(key, 0)
        else:
            if t != self._scrape_time.get(key):
                # new scrape observed: it already reflects earlier
                # dispatches AND earlier finishes
                self._scrape_time[key] = t
                self._since_scrape[key] = 0
                self._fin_since_scrape[key] = 0
            pending = self._since_scrape.get(key, 0) \
                - self._fin_since_scrape.get(key, 0)
        return max(0, scraped + pending)

    def select(self, eps: list[dict], req: Request) -> dict:
        return min(eps, key=self._depth)

    def note_dispatch(self, ep: dict, req: Request):
        super().note_dispatch(ep, req)
        key = endpoint_key(ep)
        self._inflight[key] = self._inflight.get(key, 0) + 1
        self._since_scrape[key] = self._since_scrape.get(key, 0) + 1

    def note_finish(self, ep_key: tuple, req: Request):
        if self._inflight.get(ep_key, 0) > 0:
            self._inflight[ep_key] -= 1
        self._fin_since_scrape[ep_key] = \
            self._fin_since_scrape.get(ep_key, 0) + 1

    def stats(self) -> dict:
        out = super().stats()
        out["inflight"] = {f"{n}:{p}": c
                           for (n, p), c in self._inflight.items() if c}
        return out


class SessionAffinity(RoutingPolicy):
    """Consistent hashing on the request's session key.

    A hash ring with `replicas` virtual nodes per endpoint keeps most
    sessions pinned when instances join/leave (only ~1/N of keys move on a
    scale event), so multi-turn chats keep hitting a warm KV cache.
    Requests without a session key fall back to round-robin.
    """

    name = "session_affinity"
    #: request attribute carrying the affinity key (subclasses override)
    affinity_attr = "session_id"

    def __init__(self, replicas: int = 64):
        super().__init__()
        self.replicas = replicas
        self._fallback = RoundRobin()
        self._ring_for: Optional[frozenset] = None
        self._ring: list[int] = []
        self._ring_eps: list[dict] = []
        self.affinity_hits = 0
        self.fallbacks = 0

    def _build_ring(self, eps: list[dict]):
        keys = frozenset(endpoint_key(e) for e in eps)
        if keys == self._ring_for:
            # endpoint set unchanged: refresh rows only (ids are stable)
            by_key = {endpoint_key(e): e for e in eps}
            self._ring_eps = [by_key[endpoint_key(e)] for e in self._ring_eps]
            return
        points = []
        for ep in eps:
            node, port = endpoint_key(ep)
            for r in range(self.replicas):
                points.append((_stable_hash(f"{node}:{port}#{r}"), ep))
        points.sort(key=lambda x: x[0])
        self._ring = [h for h, _ in points]
        self._ring_eps = [e for _, e in points]
        self._ring_for = keys

    def select(self, eps: list[dict], req: Request) -> dict:
        key = getattr(req, self.affinity_attr, None)
        if key is None:
            self.fallbacks += 1
            return self._fallback.select(eps, req)
        self._build_ring(eps)
        # namespace the ring key by the authenticated tenant: two tenants
        # reusing the same session id ("chat-1", a default every client
        # library ships) must pin independently — a colliding key would
        # let one tenant's traffic shape another's placement
        tenant = getattr(req, "tenant", None)
        ring_key = str(key) if tenant is None else f"{tenant}\x00{key}"
        h = _stable_hash(ring_key)
        i = bisect.bisect_right(self._ring, h) % len(self._ring)
        self.affinity_hits += 1
        return self._ring_eps[i]

    def stats(self) -> dict:
        out = super().stats()
        out.update(affinity_hits=self.affinity_hits, fallbacks=self.fallbacks)
        return out


class WorkflowAffinity(SessionAffinity):
    """Consistent hashing on the request's workflow key.

    A multi-agent pipeline issues a chain of requests whose prompts share
    a growing context (`repro_torch.data.burstgpt.agent_pipeline`): every stage
    extends the transcript the previous stage produced.  Pinning all
    stages of a workflow to one instance lets each agent's prefill reuse
    the previous agents' sealed KV blocks — and, with the kvstore tiers
    (docs/kv_store.md), even blocks already demoted off HBM.  The ring is
    tenant-namespaced exactly like session affinity.  Requests without a
    ``workflow_id`` degrade to session affinity, then round-robin, so one
    policy serves mixed workflow/chat/one-shot traffic.
    """

    name = "workflow_affinity"
    affinity_attr = "workflow_id"

    def __init__(self, replicas: int = 64):
        super().__init__(replicas=replicas)
        self._fallback = SessionAffinity(replicas=replicas)

    def stats(self) -> dict:
        out = super().stats()
        out["session_fallback"] = {
            "affinity_hits": self._fallback.affinity_hits,
            "fallbacks": self._fallback.fallbacks}
        return out


class PrefixAware(RoutingPolicy):
    """Group requests sharing a prompt prefix onto the same instance.

    The grouping key is the first `prefix_tokens` prompt tokens (one KV
    block at the engine's default block size) — exactly the granularity at
    which vLLM's prefix cache can reuse blocks. First sight of a prefix
    picks the least-loaded endpoint (when load data is available) so hot
    prefixes don't all pile onto instance 0; later requests stick. The map
    is a bounded LRU so a long-running gateway cannot leak.
    """

    name = "prefix_aware"
    wants_load_fn = True

    def __init__(self, prefix_tokens: int = 32, max_entries: int = 4096,
                 load_fn: Optional[Callable[[tuple], dict]] = None):
        super().__init__()
        self.prefix_tokens = prefix_tokens
        self.max_entries = max_entries
        self._placer = LeastLoaded(load_fn)
        self._map: OrderedDict[int, tuple] = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0

    def select(self, eps: list[dict], req: Request) -> dict:
        pre = tuple(req.prompt_tokens[:self.prefix_tokens])
        h = _stable_hash(repr(pre))
        by_key = {endpoint_key(e): e for e in eps}
        pinned = self._map.get(h)
        if pinned is not None and pinned in by_key:
            self._map.move_to_end(h)
            self.prefix_hits += 1
            return by_key[pinned]
        self.prefix_misses += 1
        ep = self._placer.select(eps, req)
        self._map[h] = endpoint_key(ep)
        self._map.move_to_end(h)
        while len(self._map) > self.max_entries:
            self._map.popitem(last=False)
        return ep

    def note_dispatch(self, ep: dict, req: Request):
        super().note_dispatch(ep, req)
        self._placer.note_dispatch(ep, req)

    def note_finish(self, ep_key: tuple, req: Request):
        self._placer.note_finish(ep_key, req)

    def stats(self) -> dict:
        out = super().stats()
        out.update(prefix_hits=self.prefix_hits,
                   prefix_misses=self.prefix_misses,
                   tracked_prefixes=len(self._map))
        return out


class _EWStat:
    """Exponentially-weighted online mean AND variance of one scalar
    series (West 1979's incremental form with a fixed decay): the
    TimeTrackingRouter statistic — the mean ranks endpoints, the variance
    prices their unpredictability into the tail-sensitive classes."""

    __slots__ = ("mean", "var", "n")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float, alpha: float):
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            diff = x - self.mean
            incr = alpha * diff
            self.mean += incr
            self.var = (1.0 - alpha) * (self.var + diff * incr)
        self.n += 1


class SLOCostRouter(RoutingPolicy):
    """Predictive SLO-aware cost routing: every signal the other policies
    consume alone, unified into one per-request score (ROADMAP item 1; the
    production-stack TimeTrackingRouter/QoE proposals).

    Per endpoint it tracks online TTFT and TBT estimators (exponentially
    weighted mean AND variance, updated from `note_finish` via the
    request's `RequestMetrics`), seeded from the control plane's roofline
    prior (`prior_fn`) while an endpoint has no observations — per-model
    performance varies enough across heterogeneous HPC nodes (arXiv
    2508.17814) that a static policy cannot pick well.  The score for a
    request of SLO class c and target output length L:

        cost(ep) = w_ttft(c) * [ ttft_hat + depth * tbt_ref        (wait)
                                 - kv_weight * hit_rate * p_ttft ] (KV)
                 + w_e2e(c)  * L * tbt_hat                         (decode)
                 + z(c) * sqrt(var_ttft + L^2 * var_tbt)           (risk)

    * `depth` is LeastLoaded's effective queue depth (scrape + own traffic
      since the scrape), scaled by the endpoint's observed per-token speed
      so a straggler's backlog costs more than the same depth on a fast
      chip;
    * `hit_rate` is the REAL per-endpoint prefix-cache hit rate, computed
      windowed between consecutive Metrics-Gateway scrapes of the engine
      `BlockAllocator`'s counters (prefix_aware pins by hash blindly; this
      term rewards the endpoint whose cache is actually hitting) and
      discounts the prefill share of the prior;
    * the variance term is the QoE knob: interactive traffic pays a high
      z, so a jittery endpoint loses interactive requests to a steadier
      one even at equal means, while batch ignores variance entirely.
    """

    name = "slo_cost"
    wants_load_fn = True
    wants_prior_fn = True

    #: slo_class -> (w_ttft, w_e2e, z): interactive is TTFT- and
    #: tail-dominated, batch cares only about completion time, standard
    #: balances both with a mild risk premium
    CLASS_WEIGHTS = {
        "interactive": (1.0, 0.15, 2.0),
        "standard": (1.0, 1.0, 0.5),
        "batch": (0.25, 1.0, 0.0),
    }

    def __init__(self, load_fn: Optional[Callable[[tuple], dict]] = None,
                 prior_fn: Optional[Callable] = None, alpha: float = 0.25,
                 depth_weight: float = 1.0, kv_weight: float = 1.0):
        super().__init__()
        self.load_fn = load_fn or (lambda key: {})
        # fn(model_name, req) -> (prior ttft s, prior tbt s) | None —
        # the ControlPlane roofline estimator
        self.prior_fn = prior_fn
        self.alpha = alpha
        self.depth_weight = depth_weight
        self.kv_weight = kv_weight
        # effective-depth term (scrape + dispatches - finishes since)
        self._lease = LeastLoaded(load_fn)
        self._ttft: dict[tuple, _EWStat] = {}
        self._tbt: dict[tuple, _EWStat] = {}
        # (node, port) -> (queries_total, hits_total, scrape_time, rate):
        # windowed prefix-hit rate between consecutive scrapes
        self._kv_last: dict[tuple, tuple] = {}
        self.selections = {c: 0 for c in SLO_CLASSES}
        self.observations = 0

    # -- signals -----------------------------------------------------------
    def _hit_rate(self, key: tuple) -> float:
        snap = self.load_fn(key) or {}
        q = snap.get("prefix_queries_total")
        t = snap.get("time")
        if q is None or t is None:
            return 0.0
        h = snap.get("prefix_hits_total", 0)
        last = self._kv_last.get(key)
        if last is None or q < last[0]:
            # first sight (or engine restarted and counters reset):
            # the cumulative ratio is the best window available
            rate = h / max(q, 1)
        elif t != last[2]:
            dq, dh = q - last[0], h - last[1]
            rate = (dh / dq) if dq > 0 else last[3]
        else:
            return last[3]
        self._kv_last[key] = (q, h, t, rate)
        return rate

    def _estimates(self, key: tuple, prior) -> tuple:
        """(ttft_hat, var_ttft, tbt_hat, var_tbt) — observed EW stats,
        falling back to the roofline prior (variance 0) with no obs."""
        p_ttft, p_tbt = prior if prior is not None else (0.0, 0.0)
        ts, bs = self._ttft.get(key), self._tbt.get(key)
        ttft_hat = ts.mean if ts is not None and ts.n else p_ttft
        var_ttft = ts.var if ts is not None and ts.n else 0.0
        tbt_hat = bs.mean if bs is not None and bs.n else p_tbt
        var_tbt = bs.var if bs is not None and bs.n else 0.0
        return ttft_hat, var_ttft, tbt_hat, var_tbt

    def score(self, ep: dict, req: Request) -> float:
        key = endpoint_key(ep)
        prior = self.prior_fn(req.model, req) if self.prior_fn else None
        ttft_hat, var_ttft, tbt_hat, var_tbt = self._estimates(key, prior)
        p_ttft = prior[0] if prior is not None else ttft_hat
        target = req.target_len()
        depth = self._lease.effective_depth(ep)
        # per-unit cost of queued work: the endpoint's own pace when
        # known, the prior otherwise — never zero on a loaded endpoint
        tbt_ref = tbt_hat if tbt_hat > 0 else \
            (prior[1] if prior is not None else 0.0)
        w_ttft, w_e2e, z = self.CLASS_WEIGHTS.get(
            getattr(req, "slo_class", "standard"),
            self.CLASS_WEIGHTS["standard"])
        wait = ttft_hat + self.depth_weight * depth * tbt_ref \
            - self.kv_weight * self._hit_rate(key) * p_ttft
        risk = z * math.sqrt(max(var_ttft, 0.0)
                             + target * target * max(var_tbt, 0.0))
        return w_ttft * max(wait, 0.0) + w_e2e * target * tbt_hat + risk

    # -- policy interface --------------------------------------------------
    def select(self, eps: list[dict], req: Request) -> dict:
        cls = getattr(req, "slo_class", "standard")
        if cls in self.selections:
            self.selections[cls] += 1
        # depth then row id break score ties (cold start with no prior:
        # all scores 0.0 -> behaves exactly like LeastLoaded)
        return min(eps, key=lambda e: (self.score(e, req),
                                       self._lease.effective_depth(e),
                                       e["id"]))

    def note_dispatch(self, ep: dict, req: Request):
        super().note_dispatch(ep, req)
        self._lease.note_dispatch(ep, req)

    def note_finish(self, ep_key: tuple, req: Request):
        self._lease.note_finish(ep_key, req)
        m = req.metrics
        if m.first_token_time is None:
            return                      # failed before a token: no signal
        ttft = m.ttft
        if ttft is not None and ttft >= 0.0:
            self._ttft.setdefault(ep_key, _EWStat()).update(ttft, self.alpha)
            self.observations += 1
        tpot = m.tpot(req.output_len)
        if tpot is not None and req.output_len > 1 and tpot >= 0.0:
            self._tbt.setdefault(ep_key, _EWStat()).update(tpot, self.alpha)

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            selections_by_class=dict(self.selections),
            observations=self.observations,
            inflight=self._lease.stats().get("inflight", {}),
            endpoint_estimates={
                f"{n}:{p}": {
                    "ttft_mean": round(s.mean, 4),
                    "ttft_std": round(math.sqrt(max(s.var, 0.0)), 4),
                    "n": s.n,
                    "tbt_mean": round(self._tbt[(n, p)].mean, 5)
                    if (n, p) in self._tbt else None,
                    "kv_hit_rate": round(self._kv_last[(n, p)][3], 3)
                    if (n, p) in self._kv_last else None,
                } for (n, p), s in self._ttft.items()})
        return out


POLICIES = {
    "round_robin": RoundRobin,
    "least_loaded": LeastLoaded,
    "session_affinity": SessionAffinity,
    "workflow_affinity": WorkflowAffinity,
    "prefix_aware": PrefixAware,
    "slo_cost": SLOCostRouter,
}


def make_policy(name: str,
                load_fn: Optional[Callable[[tuple], dict]] = None,
                prior_fn: Optional[Callable] = None,
                **kw) -> RoutingPolicy:
    """Policy factory used by the Web Gateway; `load_fn` maps an endpoint
    (node, port) key to its latest Metrics-Gateway scrape snapshot and
    `prior_fn(model, req)` returns the control plane's roofline
    (ttft, tbt) prior for cost-scoring policies."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; "
                         f"choose from {sorted(POLICIES)}") from None
    if cls.wants_load_fn:
        kw.setdefault("load_fn", load_fn)
    if cls.wants_prior_fn:
        kw.setdefault("prior_fn", prior_fn)
    return cls(**kw)


# ---------------------------------------------------------------------------
# router-side request queuing
# ---------------------------------------------------------------------------

@dataclass
class QueuedRequest:
    req: Request
    model_name: str
    enqueued_at: float
    deadline: float
    # re-dispatch closure supplied by the gateway (captures auth context)
    dispatch: Callable[[Request], int] = field(repr=False, default=None)
    attempts: int = 0          # dispatch attempts (observability / tests)


class GatewayQueue:
    """Bounded per-model holding area for requests that would otherwise be
    rejected 461 (model configured, no ready endpoint).

    capacity == 0 disables queuing (seed behaviour). Entries past their TTL
    are expired on every drain pass; `depth(model)` and `head_age(model)`
    feed the Metrics-Gateway scrape so the autoscaler sees queued demand
    even while a model has zero live instances.

    **Weighted fair queuing across tenants** (``fair_queuing=True``, the
    default): each model's queue is a set of per-tenant buckets (keyed by
    the gateway-stamped ``Request.tenant``; untenanted requests share one
    bucket) drained by start-time fair queuing on a per-model virtual
    clock.  Dispatching an entry advances its tenant's virtual time by
    ``cost / weight`` where cost is the request's *service cost in tokens*
    (prompt + target output, `cost_fn`) — share is measured in work, not
    request count, so a tenant of 100-token chat turns is not crowded out
    by a tenant of 8k-token batch prompts.  A tenant that goes idle earns
    no credit: on re-arrival its virtual time snaps forward to the queue's
    clock.  Ties on virtual time break by `TenantSpec.priority_class`
    (higher first, via ``class_fn``), then bucket arrival order.  With one
    tenant (or ``fair_queuing=False``) the queue reduces exactly to the
    PR-3 behaviour.  Admission is weighted too: an offer that finds the
    queue full may *displace* the least-urgent entry of the most
    over-share tenant (see `_displace`) instead of rejecting an
    under-share tenant at the door.

    *Within* a tenant, dequeue acts on `Request.priority`: the entry with
    the highest *effective* priority — ``priority + aging * wait_time`` —
    is dispatched first, FIFO within a priority class.  ``aging``
    (priority points per queued second, `ServiceConfig.queue_aging`) is
    the starvation-avoidance knob: with aging > 0 a long-waiting
    low-priority request eventually outranks fresh high-priority
    arrivals; at the default 0.0 ordering is strict priority, and with
    all-zero priorities it reduces to plain FIFO.

    `configure_model` installs per-deployment capacity/TTL overrides (the
    `ModelDeploymentSpec.queue_capacity` / `queue_ttl` knobs): an override
    bounds that model's own depth instead of the shared gateway total.
    """

    def __init__(self, capacity: int = 0, ttl: float = 30.0,
                 aging: float = 0.0, fair_queuing: bool = True,
                 weight_fn: Optional[Callable] = None,
                 class_fn: Optional[Callable] = None,
                 cost_fn: Optional[Callable] = None):
        self.capacity = capacity
        self.ttl = ttl
        self.aging = aging
        self.fair_queuing = fair_queuing
        # tenant name -> fair-share weight / priority class (injected by
        # the gateway from the TenancyManager; defaults = all equal)
        self.weight_fn = weight_fn or (lambda tenant: 1.0)
        self.class_fn = class_fn or (lambda tenant: 0)
        # WFQ service cost of one entry, in tokens
        self.cost_fn = cost_fn or (lambda req: req.prompt_len
                                   + req.target_len())
        # model -> tenant key -> entries in arrival order
        self._q: dict[str, OrderedDict] = {}
        self._vt: dict[str, dict] = {}      # model -> tenant virtual time
        self._v: dict[str, float] = {}      # model -> virtual clock floor
        # model -> tenant -> queued token-cost total (kept in lockstep
        # with _q; makes displacement O(tenants) instead of O(entries))
        self._cost: dict[str, dict] = {}
        # model -> (capacity override, ttl override); None = inherit
        self._model_limits: dict[str, tuple] = {}
        # fn(QueuedRequest), set by the gateway: receives entries evicted
        # by weighted admission (fair-share displacement on a full queue)
        # so their streams get a terminal 461 instead of hanging
        self.on_displaced: Optional[Callable] = None
        self.enqueued = 0
        self.drained = 0
        self.expired = 0
        self.rejected_full = 0
        self.displaced = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0 or any(
            cap is not None and cap > 0
            for cap, _ in self._model_limits.values())

    def configure_model(self, model_name: str, capacity=None, ttl=None):
        """Per-deployment queue knobs; (None, None) clears the override."""
        if capacity is None and ttl is None:
            self._model_limits.pop(model_name, None)
        else:
            self._model_limits[model_name] = (capacity, ttl)

    def limits_for(self, model_name: str) -> tuple:
        """(effective capacity, effective TTL) governing this model —
        the override where set, the gateway-wide knobs otherwise."""
        cap, ttl = self._model_limits.get(model_name, (None, None))
        return (self.capacity if cap is None else cap,
                self.ttl if ttl is None else ttl)

    def _buckets(self, model_name: str) -> OrderedDict:
        return self._q.get(model_name) or OrderedDict()

    def total_depth(self) -> int:
        return sum(len(b) for bs in self._q.values() for b in bs.values())

    def depth(self, model_name: str) -> int:
        return sum(len(b) for b in self._buckets(model_name).values())

    def depth_by_tenant(self, model_name: str) -> dict:
        """{tenant key: queued depth} for one model (non-empty buckets
        only) — the share-weighted autoscaling signal's raw input."""
        return {t: len(b) for t, b in self._buckets(model_name).items()
                if b}

    def tenant_depth(self, tenant) -> int:
        """Queued entries for one tenant across all models (per-tenant
        scrape series)."""
        return sum(len(bs.get(tenant, ())) for bs in self._q.values())

    def head_age(self, model_name: str, now: float) -> float:
        heads = [b[0].enqueued_at for b in self._buckets(model_name).values()
                 if b]
        return (now - min(heads)) if heads else 0.0

    def models(self) -> list[str]:
        return [m for m in self._q if self.depth(m)]

    def offer(self, req: Request, model_name: str, now: float,
              dispatch: Callable[[Request], int]) -> bool:
        """Try to enqueue; False means the queue is disabled or full."""
        cap, ttl = self._model_limits.get(model_name, (None, None))
        eff_cap = self.capacity if cap is None else cap
        eff_ttl = self.ttl if ttl is None else ttl
        if eff_cap <= 0:
            return False
        if cap is not None:
            full = self.depth(model_name) >= cap
            scope = [model_name]               # per-model bound
        else:
            full = self.total_depth() >= self.capacity
            scope = None                       # shared bound: all models
        tenant = getattr(req, "tenant", None) if self.fair_queuing else None
        if full and not self._displace(scope, tenant, req, now):
            self.rejected_full += 1
            return False
        buckets = self._q.setdefault(model_name, OrderedDict())
        bucket = buckets.get(tenant)
        if bucket is None:
            bucket = buckets[tenant] = deque()
        if not bucket:
            # (re-)backlogged: no credit for idle time — the tenant's
            # virtual time snaps forward to the model's clock
            vt = self._vt.setdefault(model_name, {})
            vt[tenant] = max(vt.get(tenant, 0.0),
                             self._v.get(model_name, 0.0))
        bucket.append(QueuedRequest(
            req=req, model_name=model_name, enqueued_at=now,
            deadline=now + eff_ttl, dispatch=dispatch))
        self._note_cost(model_name, tenant, req, +1)
        self.enqueued += 1
        return True

    def _note_cost(self, model_name: str, tenant, req: Request, sign: int):
        """Maintain the running queued-token total per (model, tenant) so
        displacement decisions are O(tenants), not O(queued entries)."""
        per_model = self._cost.setdefault(model_name, {})
        per_model[tenant] = per_model.get(tenant, 0.0) \
            + sign * self.cost_fn(req)

    def _displace(self, scope: Optional[list], tenant, req: Request,
                  now: float) -> bool:
        """Weighted admission on a full queue: fairness must not stop at
        the door.  If the offering tenant is further *under* its fair
        share than the most over-share backlogged tenant in scope, evict
        that tenant's least-urgent entry — lowest effective priority,
        newest among equals — to make room; the evicted entry goes to
        `on_displaced` for a terminal 461.  ``scope`` is the models the
        breached bound covers: the one model for a per-deployment
        capacity override, every queued model (None) for the shared
        gateway bound — a full shared queue must consider other models'
        hoards, or one model's backlog would still lock other models'
        tenants out.  Share is measured in queued TOKENS over weight
        (the same `cost_fn` currency the drain uses) — by count, a bulk
        tenant of few huge requests could evict an interactive tenant
        holding far less queued work.  Returns True when a slot was
        freed."""
        if not self.fair_queuing:
            return False
        models = list(self._q) if scope is None \
            else [m for m in scope if m in self._q]
        if not models:
            return False

        def ratio(t, extra_cost: float = 0.0) -> float:
            queued = sum(self._cost.get(m, {}).get(t, 0.0) for m in models)
            return (queued + extra_cost) / max(self.weight_fn(t), 1e-9)

        # deterministic candidate order (dict.fromkeys dedup preserves
        # bucket insertion order): a ratio tie must not be broken by set
        # iteration order, which varies with PYTHONHASHSEED
        backlogged = list(dict.fromkeys(
            t for m in models for t, b in self._q[m].items() if b))
        victim_t = max(backlogged, key=ratio, default=None)
        if victim_t is None or victim_t == tenant:
            return False          # the offerer is itself the worst
        if ratio(victim_t) <= ratio(tenant, extra_cost=self.cost_fn(req)):
            return False          # admitting would not improve fairness
        # least-urgent entry across the victim's in-scope buckets:
        # lowest SLO class (batch evicts before interactive), lowest
        # effective priority, newest (enqueue time) among equals
        worst = None
        for m in models:
            for i, e in enumerate(self._q[m].get(victim_t, ())):
                # arrival index breaks enqueue-time ties (same-tick
                # offers): the later arrival is the newer entry
                key = (-_SLO_RANK.get(getattr(e.req, "slo_class",
                                              "standard"),
                                      _SLO_RANK["standard"]),
                       -(e.req.priority
                         + self.aging * (now - e.enqueued_at)),
                       e.enqueued_at, i)
                if worst is None or key > worst[0]:
                    worst = (key, m, i)
        _, m, i = worst
        item = self._q[m][victim_t][i]
        del self._q[m][victim_t][i]
        self._note_cost(m, victim_t, item.req, -1)
        self._prune(m)
        self.displaced += 1
        if self.on_displaced is not None:
            self.on_displaced(item)
        return True

    def _prune(self, model_name: str):
        """Drop drained per-tenant buckets so long-lived gateways with
        tenant churn don't walk a growing set of empty deques on every
        tick.  The tenant's _vt entry is kept deliberately: its virtual
        time is the debt of work already consumed — deleting it would let
        a tenant dodge WFQ accounting by letting its bucket drain."""
        buckets = self._q.get(model_name)
        if buckets is None:
            return
        for t in [t for t, b in buckets.items() if not b]:
            del buckets[t]
            self._cost.get(model_name, {}).pop(t, None)
        if not buckets:
            del self._q[model_name]
            self._cost.pop(model_name, None)

    def expire(self, now: float) -> list[QueuedRequest]:
        """Drop every entry past its deadline.  The whole bucket is
        scanned, not just the head: deadlines are NOT monotone within a
        bucket — a `configure_model` TTL override applied mid-run (the
        Reconciler does this on spec updates) gives later arrivals
        earlier deadlines, and head-only expiry would strand them behind
        a longer-deadline head, hanging their streams far past the
        advertised retry_after."""
        out = []
        for model_name, buckets in list(self._q.items()):
            for t, b in buckets.items():
                if any(e.deadline <= now for e in b):
                    keep = deque(e for e in b if e.deadline > now)
                    for item in b:
                        if item.deadline <= now:
                            self._note_cost(model_name, t, item.req, -1)
                            out.append(item)
                    buckets[t] = keep
            self._prune(model_name)
        self.expired += len(out)
        return out

    def _select(self, q: deque, now: float) -> int:
        """Index of the next entry to dispatch within one tenant bucket:
        SLO class first (interactive > standard > batch — a drained slot
        should clear the latency-sensitive backlog before bulk work),
        then highest effective priority (priority + aging * wait), FIFO
        tie-break — entries sit in arrival order and the strict `>` keeps
        the earliest among equals."""
        best_i, best_key = 0, None
        for i, item in enumerate(q):
            key = (_SLO_RANK.get(getattr(item.req, "slo_class", "standard"),
                                 _SLO_RANK["standard"]),
                   item.req.priority + self.aging * (now - item.enqueued_at))
            if best_key is None or key > best_key:
                best_i, best_key = i, key
        return best_i

    def _next_tenant(self, model_name: str):
        """Backlogged tenant with the smallest virtual time (start-time
        fair queuing); ties break by priority class (higher first), then
        bucket arrival order."""
        vt = self._vt.get(model_name, {})
        best, best_key = None, None
        for i, (tenant, b) in enumerate(self._q[model_name].items()):
            if not b:
                continue
            key = (vt.get(tenant, 0.0), -self.class_fn(tenant), i)
            if best_key is None or key < best_key:
                best, best_key = tenant, key
        return best

    def drain(self, model_name: str, now: float,
              can_dispatch: Callable[[str], bool]) -> int:
        """Re-dispatch queued requests for `model_name` while an endpoint
        is ready, in WFQ order across tenants. Returns the number
        forwarded."""
        if model_name not in self._q:
            return 0
        n = 0
        while self.depth(model_name) and can_dispatch(model_name):
            tenant = self._next_tenant(model_name)
            bucket = self._q[model_name][tenant]
            i = self._select(bucket, now)
            item = bucket[i]
            del bucket[i]
            item.attempts += 1
            status = item.dispatch(item.req)
            if status != 200:
                # endpoint vanished between the check and the dispatch:
                # put it back where it was and stop this pass
                bucket.insert(i, item)
                break
            self._note_cost(model_name, tenant, item.req, -1)
            vt = self._vt.setdefault(model_name, {})
            start = max(vt.get(tenant, 0.0), self._v.get(model_name, 0.0))
            self._v[model_name] = start
            vt[tenant] = start + self.cost_fn(item.req) \
                / max(self.weight_fn(tenant), 1e-9)
            n += 1
        self._prune(model_name)
        self.drained += n
        return n

    def stats(self) -> dict:
        by_tenant: dict = {}
        for buckets in self._q.values():
            for t, b in buckets.items():
                if b:
                    key = t if t is not None else ""
                    by_tenant[key] = by_tenant.get(key, 0) + len(b)
        out = {"depth": self.total_depth(), "enqueued": self.enqueued,
               "drained": self.drained, "expired": self.expired,
               "rejected_full": self.rejected_full,
               "displaced": self.displaced}
        if by_tenant:
            out["by_tenant"] = by_tenant
        return out
