"""Multi-tenant QoS: tenant specs, token-bucket quotas and usage metering.

The paper's target is *shared* higher-education infrastructure — many
departments and course cohorts behind one gateway — but its tenants exist
only as authentication rows (`identity_tenants`).  Chat AI (arXiv
2407.00110) runs the comparable university-consortium service and makes
per-user-group isolation first-class; the vLLM production-stack router
treats per-tenant limits as table stakes.  This module is that missing
QoS layer:

* `TenantSpec`       — desired QoS state of one tenant: fair-share
  ``weight`` (the WFQ share in `GatewayQueue`), token-bucket rate limits
  (``requests_per_sec`` / ``tokens_per_min`` with explicit burst
  allowances), a ``max_inflight`` concurrency cap and a ``priority_class``
  that orders tenants at equal virtual time.  Strictly validated
  (422 + ``param``), ``to_dict``/``from_dict`` manifests — the same
  contract as `ModelDeploymentSpec`.
* `TokenBucket`      — the standard refill-rate/capacity bucket; quota
  rejections derive their ``retry_after`` from the refill time of the
  exhausted bucket.
* `TenancyManager`   — admission (`admit` → 429 `APIError` or None),
  per-tenant in-flight tracking, and DB-backed usage metering
  (`tenant_usage_records`: request counts, prompt/completion tokens,
  queue wait and KV-transfer time per 60 s window) scraped by the
  Metrics Gateway as per-tenant series.  Specs persist in
  `identity_tenant_policies` (1:1 with `identity_tenants`), administered
  through the `AdminClient` tenant verbs.

Enforcement points: the Web Gateway calls `admit` inside `api_handle`
(bucket/inflight rejections answer the new 429 wire error) and the
`GatewayQueue` consumes `weight`/`priority_class` for weighted fair
queuing across tenants (see repro_torch.core.router).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.api.errors import APIError, check_int as _check_int
from repro_torch.api.errors import check_number as _check_number
from repro_torch.api.errors import error_for_status
from repro_torch.api.errors import raise_validation as _fail
from repro_torch.api.tenancy import TenantUsage
from repro_torch.core.db import Database
from repro_torch.core.simclock import EventLoop
from repro_torch.engine.request import Request, RequestStatus

#: metering window for tenant_usage_records rows (seconds)
USAGE_WINDOW = 60.0

TENANT_QUOTA_EXCEEDED = 429


@dataclass
class TenantSpec:
    """Desired QoS state of one tenant (the `identity_tenants` row named
    by ``name`` must already exist — auth and QoS are separate concerns,
    created separately)."""
    name: str
    # fair-share weight for weighted fair queuing in the gateway queue:
    # backlogged tenants receive service (measured in tokens, not request
    # count) proportional to their weights
    weight: float = 1.0
    # token-bucket rate limits; None = unlimited on that dimension
    requests_per_sec: Optional[float] = None
    tokens_per_min: Optional[float] = None       # prompt + target tokens
    # burst allowances (bucket capacities); None derives a default:
    # max(1, requests_per_sec) requests / one minute's tokens
    burst_requests: Optional[int] = None
    burst_tokens: Optional[int] = None
    # concurrency cap across all models; None = unlimited
    max_inflight: Optional[int] = None
    # orders tenants at equal WFQ virtual time (higher drains first);
    # within a tenant, per-request `Request.priority` + aging still rule
    priority_class: int = 0

    def validate(self):
        """Strict field-addressed validation — violations raise a 422
        `APIStatusError` whose ``param`` names the field (the
        `ModelDeploymentSpec` contract)."""
        if not isinstance(self.name, str) or not self.name:
            _fail("name", "name must be a non-empty string")
        _check_number(self.weight, "weight", minimum=1e-9)
        if self.requests_per_sec is not None:
            _check_number(self.requests_per_sec, "requests_per_sec",
                          minimum=1e-9)
        if self.tokens_per_min is not None:
            _check_number(self.tokens_per_min, "tokens_per_min",
                          minimum=1e-9)
        if self.burst_requests is not None:
            _check_int(self.burst_requests, "burst_requests", minimum=1)
            if self.requests_per_sec is None:
                _fail("burst_requests",
                      "burst_requests requires requests_per_sec")
        if self.burst_tokens is not None:
            _check_int(self.burst_tokens, "burst_tokens", minimum=1)
            if self.tokens_per_min is None:
                _fail("burst_tokens", "burst_tokens requires tokens_per_min")
        if self.max_inflight is not None:
            _check_int(self.max_inflight, "max_inflight", minimum=1)
        _check_int(self.priority_class, "priority_class")

    def to_dict(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "requests_per_sec": self.requests_per_sec,
                "tokens_per_min": self.tokens_per_min,
                "burst_requests": self.burst_requests,
                "burst_tokens": self.burst_tokens,
                "max_inflight": self.max_inflight,
                "priority_class": self.priority_class}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            _fail(unknown[0],
                  f"unknown field(s) {unknown} in TenantSpec manifest")
        return cls(**d)


class TokenBucket:
    """Refill-rate / capacity token bucket on the virtual clock."""

    def __init__(self, rate: float, capacity: float):
        self.rate = rate              # tokens per second
        self.capacity = capacity
        self.level = capacity         # buckets start full (burst allowed)
        self._t = 0.0

    def _refill(self, now: float):
        if now > self._t:
            self.level = min(self.capacity,
                             self.level + (now - self._t) * self.rate)
            self._t = now

    def wait_for(self, n: float, now: float) -> float:
        """Seconds until `n` tokens are available (0.0 = available now).
        A charge larger than the bucket capacity still yields the honest
        refill time — the caller decides whether to surface it."""
        self._refill(now)
        if self.level >= n:
            return 0.0
        return (n - self.level) / self.rate

    def take(self, n: float, now: float):
        self._refill(now)
        self.level -= n


class TenancyManager:
    """Per-tenant QoS state over the central DB: specs, buckets, in-flight
    counts and usage metering.  The Web Gateway enforces; the Metrics
    Gateway scrapes; the `AdminClient` administers."""

    def __init__(self, db: Database, loop: EventLoop):
        self.db = db
        self.loop = loop
        self.specs: dict[str, TenantSpec] = {}
        self._req_buckets: dict[str, TokenBucket] = {}
        self._tok_buckets: dict[str, TokenBucket] = {}
        self.inflight: dict[str, int] = {}
        # running usage totals (scrape-friendly mirror of the DB records)
        self.totals: dict[str, dict] = {}
        self.rejections: dict[str, int] = {}
        # tenants deleted while requests were still in flight: their
        # in-memory accounting is reaped once the last request closes
        self._deleted: set = set()
        # adaptive max_inflight backpressure: EW-smoothed inter-completion
        # gap per tenant — a slot frees roughly once per gap, so it is the
        # honest retry_after hint for an in-flight-full 429
        self._last_done: dict[str, float] = {}
        self._done_gap: dict[str, float] = {}
        self._load()

    # -- spec administration (AdminClient verbs) -----------------------------
    def _load(self):
        """Rebuild specs from `identity_tenant_policies` (a manager
        constructed over an existing DB picks up persisted QoS state)."""
        for row in self.db["identity_tenant_policies"].rows.values():
            tenant = self.db["identity_tenants"].get(row["tenant_id"])
            if tenant is None:
                continue
            spec = TenantSpec(name=tenant["name"], **{
                k: row[k] for k in ("weight", "requests_per_sec",
                                    "tokens_per_min", "burst_requests",
                                    "burst_tokens", "max_inflight",
                                    "priority_class")})
            self.specs[spec.name] = spec
            self._rebuild_buckets(spec)

    def _tenant_row(self, name: str) -> Optional[dict]:
        rows = self.db["identity_tenants"].select(name=name)
        return rows[0] if rows else None

    def _rebuild_buckets(self, spec: TenantSpec):
        name = spec.name
        if spec.requests_per_sec is not None:
            cap = spec.burst_requests if spec.burst_requests is not None \
                else max(1.0, spec.requests_per_sec)
            self._req_buckets[name] = TokenBucket(spec.requests_per_sec, cap)
        else:
            self._req_buckets.pop(name, None)
        if spec.tokens_per_min is not None:
            cap = spec.burst_tokens if spec.burst_tokens is not None \
                else spec.tokens_per_min
            self._tok_buckets[name] = TokenBucket(spec.tokens_per_min / 60.0,
                                                  cap)
        else:
            self._tok_buckets.pop(name, None)

    def apply(self, spec) -> TenantSpec:
        """Create or update one tenant's QoS policy.  Accepts a
        `TenantSpec` or its dict manifest; the tenant's auth row must
        already exist (`Database.create_tenant`).  Re-applying resets the
        tenant's buckets to the new limits (full, burst allowed)."""
        if isinstance(spec, dict):
            spec = TenantSpec.from_dict(spec)
        spec.validate()
        tenant = self._tenant_row(spec.name)
        if tenant is None:
            _fail("name", f"tenant {spec.name!r} does not exist; create it "
                          f"(with its API key) before applying a QoS spec")
        fields = {k: v for k, v in spec.to_dict().items() if k != "name"}
        rows = self.db["identity_tenant_policies"].select(
            tenant_id=tenant["id"])
        if rows:
            self.db["identity_tenant_policies"].update(rows[0]["id"],
                                                       **fields)
        else:
            self.db["identity_tenant_policies"].insert(
                self.db, tenant_id=tenant["id"], **fields)
        self.specs[spec.name] = spec
        self._rebuild_buckets(spec)
        self._deleted.discard(spec.name)      # resurrection cancels reap
        return spec

    def get(self, name: str) -> Optional[TenantSpec]:
        return self.specs.get(name)

    def list(self) -> list:
        return [self.specs[n] for n in sorted(self.specs)]

    def delete(self, name: str) -> bool:
        """Remove the QoS policy (the tenant's auth row stays — back to
        the unlimited / weight-1.0 default).  In-memory accounting for
        the tenant is dropped too — under tenant churn (per-course
        accounts), deleted tenants must fall out of `tracked()` or the
        scrape walks ghosts forever; the DB usage records remain (they
        are the billing archive)."""
        spec = self.specs.pop(name, None)
        self._req_buckets.pop(name, None)
        self._tok_buckets.pop(name, None)
        if self.inflight.get(name):
            # keep the live count; the last on_request_done reaps it
            self._deleted.add(name)
        else:
            self.inflight.pop(name, None)
        self.totals.pop(name, None)
        self.rejections.pop(name, None)
        self._last_done.pop(name, None)
        self._done_gap.pop(name, None)
        tenant = self._tenant_row(name)
        if tenant is not None:
            for row in self.db["identity_tenant_policies"].select(
                    tenant_id=tenant["id"]):
                self.db["identity_tenant_policies"].delete(self.db,
                                                           row["id"])
        return spec is not None

    # -- WFQ inputs (GatewayQueue) -------------------------------------------
    def weight(self, name: Optional[str]) -> float:
        spec = self.specs.get(name) if name is not None else None
        return spec.weight if spec is not None else 1.0

    def priority_class(self, name: Optional[str]) -> int:
        spec = self.specs.get(name) if name is not None else None
        return spec.priority_class if spec is not None else 0

    # -- admission (WebGateway.api_handle) -----------------------------------
    @staticmethod
    def charge(req: Request) -> int:
        """Tokens a request charges against the token bucket at admission:
        the prompt plus the *target* output (the actual completion length
        is unknown until finish; charging the budget up front is what
        keeps a tenant from launching 1000 max-length decodes for free)."""
        return req.prompt_len + req.target_len()

    def admit(self, name: str, req: Request, now: float) -> Optional[APIError]:
        """Quota check for one request.  Returns None and commits the
        charges (buckets drawn, in-flight incremented) on admission, or a
        structured 429 `APIError` whose ``retry_after`` is the refill time
        of the exhausted bucket.  Check-then-commit: a rejection draws
        nothing."""
        spec = self.specs.get(name)
        if spec is not None:
            if spec.max_inflight is not None \
                    and self.inflight.get(name, 0) >= spec.max_inflight:
                self.rejections[name] = self.rejections.get(name, 0) + 1
                # hint the observed completion cadence: a slot frees about
                # once per smoothed inter-completion gap (1 s until the
                # tenant has finished anything this run)
                gap = self._done_gap.get(name)
                retry = 1.0 if gap is None else min(60.0, max(0.05, gap))
                return error_for_status(
                    TENANT_QUOTA_EXCEEDED, retry_after=retry,
                    message=f"Tenant {name!r} has {spec.max_inflight} "
                            f"requests in flight (max_inflight).")
            rb = self._req_buckets.get(name)
            tb = self._tok_buckets.get(name)
            if tb is not None and self.charge(req) > tb.capacity:
                # can NEVER fit the burst allowance: a retry_after hint
                # would send the client into an honest-looking retry loop
                # that cannot succeed — reject without one
                self.rejections[name] = self.rejections.get(name, 0) + 1
                return error_for_status(
                    TENANT_QUOTA_EXCEEDED,
                    message=f"Request of {self.charge(req)} tokens exceeds "
                            f"tenant {name!r}'s burst capacity of "
                            f"{tb.capacity:.0f} tokens; it can never be "
                            f"admitted under this quota.")
            wait_r = rb.wait_for(1.0, now) if rb is not None else 0.0
            wait_t = tb.wait_for(self.charge(req), now) \
                if tb is not None else 0.0
            if wait_r > 0.0 or wait_t > 0.0:
                self.rejections[name] = self.rejections.get(name, 0) + 1
                dim = "requests/sec" if wait_r >= wait_t else "tokens/min"
                return error_for_status(
                    TENANT_QUOTA_EXCEEDED,
                    retry_after=max(wait_r, wait_t),
                    message=f"Tenant {name!r} exceeded its {dim} quota.")
            if rb is not None:
                rb.take(1.0, now)
            if tb is not None:
                tb.take(self.charge(req), now)
        self.inflight[name] = self.inflight.get(name, 0) + 1
        return None

    # -- metering (stream on_done) -------------------------------------------
    def on_request_done(self, name: str, req: Request, now: float,
                        failed: Optional[bool] = None):
        """Terminal accounting for one admitted request: release the
        in-flight slot and fold the request into the tenant's windowed
        usage record (prompt/completion tokens from the engine-stamped
        `RequestMetrics`, queue wait, KV-transfer time).  ``failed`` is
        the stream's terminal verdict (closed with an error) when the
        caller has one; the request-status fallback covers direct
        engine-path callers."""
        if self.inflight.get(name, 0) > 0:
            self.inflight[name] -= 1
        m = req.metrics
        if failed is None:
            failed = req.status == RequestStatus.FAILED
        if m.finish_time is not None:      # engine-recorded accounting
            prompt, completion = m.prompt_tokens, m.completion_tokens
            # admission charged prompt + TARGET output; an early stop (EOS,
            # client stop strings) used less — flow the surplus back into
            # the tokens/min bucket so conservative max_tokens settings
            # don't eat the tenant's real throughput budget
            surplus = self.charge(req) - (prompt + completion)
            tb = self._tok_buckets.get(name)
            if surplus > 0 and tb is not None:
                tb.level = min(tb.capacity, tb.level + surplus)
        elif m.first_scheduled_time is not None:
            # died mid-service (instance loss): the prefill and any
            # streamed tokens were real work
            prompt, completion = req.prompt_len, req.output_len
        else:
            # never reached an engine (461 rejection, queue expiry): no
            # work was performed, so no tokens are billed — usage token
            # counts must stay reconcilable with engine metrics — and the
            # admission charge flows back into the token bucket.  The
            # requests/sec bucket is NOT refunded: admission attempts are
            # real load.  (A spec re-applied mid-flight may make the
            # refund approximate; buckets reset on apply anyway.)
            prompt, completion = 0, 0
            tb = self._tok_buckets.get(name)
            if tb is not None:
                tb.level = min(tb.capacity, tb.level + self.charge(req))
        if m.first_scheduled_time is not None:
            wait = max(0.0, m.first_scheduled_time - m.gateway_time)
        else:                          # failed before ever being scheduled
            wait = max(0.0, now - m.gateway_time)
        tenant = self._tenant_row(name)
        if tenant is not None:
            window = (now // USAGE_WINDOW) * USAGE_WINDOW
            rows = self.db["tenant_usage_records"].select(
                tenant_id=tenant["id"], model_name=req.model,
                window_start=window)
            if rows:
                r = rows[0]
                self.db["tenant_usage_records"].update(
                    r["id"], requests=r["requests"] + 1,
                    failed=r["failed"] + (1 if failed else 0),
                    prompt_tokens=r["prompt_tokens"] + prompt,
                    completion_tokens=r["completion_tokens"] + completion,
                    queue_wait=r["queue_wait"] + wait,
                    kv_transfer_time=r["kv_transfer_time"]
                    + m.kv_transfer_time)
            else:
                self.db["tenant_usage_records"].insert(
                    self.db, tenant_id=tenant["id"], model_name=req.model,
                    window_start=window, requests=1,
                    failed=1 if failed else 0, prompt_tokens=prompt,
                    completion_tokens=completion, queue_wait=wait,
                    kv_transfer_time=m.kv_transfer_time)
        t = self.totals.setdefault(name, {
            "requests": 0, "failed": 0, "prompt_tokens": 0,
            "completion_tokens": 0, "queue_wait": 0.0,
            "kv_transfer_time": 0.0})
        t["requests"] += 1
        t["failed"] += 1 if failed else 0
        t["prompt_tokens"] += prompt
        t["completion_tokens"] += completion
        t["queue_wait"] += wait
        t["kv_transfer_time"] += m.kv_transfer_time
        # completion cadence for the adaptive max_inflight retry_after
        last = self._last_done.get(name)
        self._last_done[name] = now
        if last is not None:
            dt = max(0.0, now - last)
            old = self._done_gap.get(name)
            self._done_gap[name] = dt if old is None \
                else 0.8 * old + 0.2 * dt
        if name in self._deleted and not self.inflight.get(name):
            # last in-flight request of a deleted tenant closed: reap the
            # in-memory accounting so the scrape stops walking a ghost
            # (the DB usage rows above remain — the billing archive)
            self._deleted.discard(name)
            self.inflight.pop(name, None)
            self.totals.pop(name, None)
            self.rejections.pop(name, None)
            self._last_done.pop(name, None)
            self._done_gap.pop(name, None)

    # -- reporting -----------------------------------------------------------
    def tracked(self) -> list:
        """Tenant names worth a per-tenant scrape series: any with a QoS
        spec or with traffic observed this run."""
        return sorted(set(self.specs) | set(self.inflight))

    def usage_records(self, name: str, since: Optional[float] = None,
                      model: Optional[str] = None) -> list[dict]:
        """Raw windowed usage rows for one tenant (wire-shaped dicts)."""
        tenant = self._tenant_row(name)
        if tenant is None:
            return []
        rows = self.db["tenant_usage_records"].select(tenant_id=tenant["id"])
        out = []
        for r in sorted(rows, key=lambda r: (r["window_start"], r["id"])):
            if since is not None and r["window_start"] < since:
                continue
            if model is not None and r["model_name"] != model:
                continue
            out.append({k: r[k] for k in
                        ("model_name", "window_start", "requests", "failed",
                         "prompt_tokens", "completion_tokens", "queue_wait",
                         "kv_transfer_time")})
        return out

    def usage(self, name: str, since: Optional[float] = None,
              model: Optional[str] = None) -> TenantUsage:
        """Aggregated usage across windows — the wire `TenantUsage`."""
        return TenantUsage.from_records(
            name, self.usage_records(name, since=since, model=model))
