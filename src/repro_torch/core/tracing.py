"""Distributed request tracing: span trees + critical-path attribution.

The paper's headline number — the whole Slurm/Kubernetes/vLLM stack adds
"only ~500 ms" of end-to-end overhead — is a blanket figure; neither the
paper nor `RequestMetrics`' scalar timestamps can say *where* that
overhead lives once a request traverses auth -> WFQ tenant queue ->
router -> (prefill engine -> chunked KV handoff -> decode engine) ->
token stream.  This module is the OpenTelemetry-shaped answer: every
gateway request carries a `RequestTrace` (span tree on the virtual
clock) and the `Tracer` retains, aggregates and serves them.

Span taxonomy (docs/tracing.md):

* ``request`` — the root: gateway arrival to terminal client delivery.
* ``gateway.auth`` — bearer-token lookup (cache hit vs DB trip).
* ``gateway.queue`` — held in the gateway's WFQ/TTL queue.
* ``router.select`` — endpoint choice + DB trip + forward hop, one per
  dispatch (two for a disaggregated request, more after retries).
* ``engine.queue`` — FCFS wait at ONE engine (per hop; this is exactly
  `RequestMetrics.local_queue_time`).
* ``engine.prefill`` / ``engine.decode`` — the compute phases.
* ``kv.handoff`` + ``kv.handoff.chunk`` children — the prefill->decode
  payload riding the shared-NIC `LinkContentionModel`, one child per
  chunk reservation.
* ``stream.emit`` — the terminal response hop back to the client.

Every span of one request is a child of the root (hop/retry context in
attributes), so a re-run prefill after instance loss or a
fallback-to-unified dispatch shows up as a SIBLING span — it never
vanishes into an overwritten scalar.

Determinism: trace ids derive from `request_id`, sampling decisions from
a keyed blake2b digest (`router._stable_hash`), and recording adds ZERO
virtual time and schedules NOTHING on the EventLoop — twin sanitized
runs produce bit-identical span forests (tests/test_determinism.py) and
tracing on/off cannot move a single event (the <1 % overhead assertion
of benchmarks/trace_overhead.py is exact by construction).

Sampling is head-based but applied at RETENTION: the decision is a pure
function of the trace id (plus `ServiceConfig` per-tenant overrides),
never of the outcome — except that errors and SLO-misses are always
retained (the traces an operator actually pages through).
"""
from __future__ import annotations

import hashlib
import json
from collections import OrderedDict, deque
from typing import Callable, Optional, Union

from repro_torch.config import ServiceConfig
from repro_torch.core.router import _stable_hash

#: the closed span vocabulary (docs/tracing.md); attributes carry the
#: variable context (tenant, slo_class, endpoint, phase, retry reason)
SPAN_KINDS = ("request", "gateway.auth", "gateway.queue", "router.select",
              "engine.queue", "engine.prefill", "engine.decode",
              "kv.handoff", "kv.handoff.chunk", "stream.emit")

#: compute phases — everything else on a critical path is stack overhead
COMPUTE_KINDS = ("engine.prefill", "engine.decode")

#: per-(model, kind) duration samples held between MetricsGateway folds
_MAX_PENDING = 4096
#: SLO-miss exemplar trace ids held per model between folds
_MAX_EXEMPLARS = 16


class Span:
    """One timed operation.  ``end is None`` while open; `close` is
    idempotent (the first close wins — a force-close at trace finish
    cannot clobber a real one)."""

    __slots__ = ("span_id", "parent_id", "name", "start", "end", "status",
                 "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 start: float, attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.status = "ok"
        self.attrs: dict = dict(attrs) if attrs else {}

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def close(self, end: float, status: str = "ok", **attrs) -> "Span":
        if self.end is None:
            self.end = end
            self.status = status
            if attrs:
                self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "start": self.start, "end": self.end,
                "status": self.status, "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Span({self.name!r}, [{self.start:.6f}, "
                f"{self.end if self.end is None else round(self.end, 6)}], "
                f"{self.status})")


class RequestTrace:
    """The span tree of one request.  Spans started WITHOUT keeping the
    returned handle are trace-owned: whoever knows the end time later
    closes them by name (`close_span`), and `finish` force-closes any
    leftovers — an interrupted hop can never leak an open span."""

    __slots__ = ("trace_id", "spans", "root", "finished", "_next_span_id")

    def __init__(self, trace_id: str, start: float,
                 root_attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.finished = False
        self._next_span_id = 0
        self.root = self._new_span(None, "request", start, root_attrs)

    def _new_span(self, parent_id: Optional[int], name: str, start: float,
                  attrs: Optional[dict]) -> Span:
        s = Span(self._next_span_id, parent_id, name, start, attrs)
        self._next_span_id += 1
        self.spans.append(s)
        return s

    # -- recording ---------------------------------------------------------
    def start_span(self, name: str, start: float,
                   parent: Optional[Span] = None, **attrs) -> Span:
        """Open a span (child of `parent`, default the root).  On an
        already-finished trace the returned span is detached (not
        recorded) so straggler events after terminal close are inert."""
        if self.finished:
            return Span(-1, None, name, start, attrs)
        pid = self.root.span_id if parent is None else parent.span_id
        return self._new_span(pid, name, start, attrs)

    def open_span(self, name: str) -> Optional[Span]:
        """The most recently opened, still-open span of this name."""
        for s in reversed(self.spans):
            if s.name == name and s.end is None:
                return s
        return None

    def close_span(self, name: str, end: float, status: str = "ok",
                   **attrs) -> Optional[Span]:
        """Close the newest open span of `name`; no-op (None) when none
        is open — callers need not track whether the hop was recorded."""
        s = self.open_span(name)
        if s is not None:
            s.close(end, status=status, **attrs)
        return s

    def annotate(self, **attrs):
        self.root.attrs.update(attrs)

    def interrupt(self, end: float, reason: str):
        """Close every open non-root span with an error status (instance
        loss, mid-stream re-dispatch): the re-run's spans then appear as
        SIBLINGS next to the interrupted ones instead of replacing them."""
        for s in self.spans:
            if s.end is None and s is not self.root:
                s.close(end, status="error", reason=reason)

    def finish(self, end: float, status: str = "ok", **attrs):
        """Terminal close: force-close leftovers, close the root."""
        if self.finished:
            return
        leftover = "ok" if status == "ok" else "error"
        for s in self.spans:
            if s.end is None and s is not self.root:
                s.close(end, status=leftover, force_closed=True)
        self.root.close(end, status=status, **attrs)
        self.finished = True

    # -- views -------------------------------------------------------------
    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id,
                "spans": [s.to_dict() for s in self.spans]}


def critical_path(trace: RequestTrace) -> list[Span]:
    """The span chain that actually bounds the request's e2el.

    Greedy backward walk over the trace's LEAF spans (a parent like
    ``kv.handoff`` is represented by its chunk children): starting from
    the latest completion, repeatedly pick the span whose end gated the
    cursor — the latest-ending span with ``end <= cursor`` (ties: latest
    start, then span id) — and jump the cursor to its start.  Spans that
    end after the cursor overlapped the chosen one (e.g. handoff tail
    chunks racing the decode hop) and are skipped: they were off the
    path.  Returned in chronological order."""
    done = [s for s in trace.spans
            if s.parent_id is not None and s.end is not None]
    if not done:
        return []
    parent_ids = {s.parent_id for s in done}
    leaves = [s for s in done if s.span_id not in parent_ids] or done
    eps = 1e-9
    cursor = max(s.end for s in leaves)
    path: list[Span] = []
    remaining = list(leaves)
    while remaining:
        cands = [s for s in remaining if s.end <= cursor + eps]
        if not cands:
            break
        s = max(cands, key=lambda x: (x.end, x.start, x.span_id))
        path.append(s)
        cursor = s.start
        remaining = [r for r in cands
                     if r is not s and r.end <= cursor + eps]
    path.reverse()
    return path


def head_sampled(trace_id: str, rate: float) -> bool:
    """Head-based sampling decision: a pure, deterministic function of
    the trace id (keyed digest, not the salted builtin hash) — never of
    the request's outcome."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (_stable_hash(trace_id) % 1_000_000) < rate * 1_000_000


class Tracer:
    """Owns trace lifecycle, retention and aggregation.

    Construction is knob-driven (`ServiceConfig`): ``tracing_enabled``,
    ``trace_sample_rate``, per-tenant ``tenant_trace_sample_rates`` and
    the ``trace_max_retained`` bound on the retained store.  The tracer
    never touches the EventLoop: `begin`/`finish` are called from the
    gateway's existing control flow and all times are passed in."""

    def __init__(self, services: Optional[ServiceConfig] = None):
        svc = services or ServiceConfig()
        self.enabled = svc.tracing_enabled
        self.sample_rate = svc.trace_sample_rate
        self.tenant_rates = dict(svc.tenant_trace_sample_rates)
        self.max_retained = svc.trace_max_retained
        self.slo_targets = dict(svc.slo_targets)
        #: retained traces, oldest first (bounded by max_retained)
        self.traces: OrderedDict[str, RequestTrace] = OrderedDict()
        self.started = 0
        self.finished_total = 0
        self.retained_total = 0
        self.sampled_out = 0
        self.errors_total = 0
        self.slo_miss_total = 0
        # (model, span kind) -> duration samples pending a MetricsGateway
        # fold; bounded so a model without scrapes cannot grow memory
        self._durations: dict[tuple, deque] = {}
        self._miss_counts: dict[str, int] = {}
        self._exemplars: dict[str, list] = {}
        self._watchers: list[Callable] = []
        # repro_torch.core.telemetry.TelemetryStore (set by the ControlPlane;
        # None = burn-rate telemetry off): `finish` feeds it one
        # attainment observation per completed request, synchronously —
        # the telemetry feed inherits this tracer's zero-scheduling
        # determinism guarantee
        self.telemetry = None

    # -- lifecycle (WebGateway) --------------------------------------------
    def begin(self, req, now: float) -> Optional[RequestTrace]:
        """Stamp `req` with a trace (idempotent; None when disabled)."""
        if not self.enabled:
            return None
        if req.trace is not None:
            return req.trace
        tr = RequestTrace(f"trace-{req.request_id:08d}", now)
        tr.annotate(request_id=req.request_id)
        req.trace = tr
        self.started += 1
        return tr

    def finish(self, req, stream, now: float):
        """Terminal close (wired to the stream's `on_done`): emit the
        ``stream.emit`` span, decide retention, fold durations."""
        tr = req.trace
        if tr is None or tr.finished:
            return
        m = req.metrics
        err = getattr(stream, "error", None)
        end = now
        slo_miss = False
        if err is None:
            hop = getattr(stream, "transport_delay", 0.0)
            # the terminal hook fires INSIDE the engine's token callback,
            # before finish_time is stamped — recover the last token's
            # engine timestamp from the stream's own event log (`now` is
            # the loop time of the emitting step, which LAGS the engine's
            # virtual completion time t_done that every span close used)
            fin = m.finish_time
            if fin is None:
                evs = getattr(stream, "events", None) or ()
                fin = (evs[-1].t - hop) if evs else now
            end = fin + hop
            tr.start_span("stream.emit", fin,
                          tokens=req.output_len).close(end)
            target = self.slo_targets.get(req.slo_class)
            ttft = m.ttft
            e2el = fin - m.arrival_time
            slo_miss = bool(target is not None and ttft is not None
                            and (ttft > target.ttft or e2el > target.e2el))
        rate = self.tenant_rates.get(req.tenant, self.sample_rate) \
            if req.tenant is not None else self.sample_rate
        head = head_sampled(tr.trace_id, rate)
        status = "ok" if err is None else "error"
        tr.finish(end, status=status,
                  error=getattr(err, "code", None) if err is not None
                  else None,
                  slo_miss=slo_miss, sampled=head,
                  preemptions=m.preemptions, retries=req.disagg_retries,
                  kv_transfer_time=m.kv_transfer_time)
        self.finished_total += 1
        if err is not None:
            self.errors_total += 1
        model = req.model or ""
        for s in tr.spans:
            key = (model, s.name)
            dq = self._durations.get(key)
            if dq is None:
                dq = self._durations[key] = deque(maxlen=_MAX_PENDING)
            dq.append(s.end - s.start)
        if slo_miss:
            self.slo_miss_total += 1
            self._miss_counts[model] = self._miss_counts.get(model, 0) + 1
            ex = self._exemplars.setdefault(model, [])
            if len(ex) < _MAX_EXEMPLARS:
                ex.append(tr.trace_id)
        if self.telemetry is not None:
            # one attainment observation per request (shed requests are
            # filtered inside — they must not feed the alert that shed
            # them); non-shed errors burn budget like SLO misses
            self.telemetry.observe(model, req.slo_class, tr, slo_miss,
                                   error=err is not None, t=end)
        if head or err is not None or slo_miss:
            self.traces[tr.trace_id] = tr
            self.retained_total += 1
            while len(self.traces) > self.max_retained:
                self.traces.popitem(last=False)
            for fn in list(self._watchers):
                fn(tr)
        else:
            self.sampled_out += 1

    # -- query surface (AdminClient trace verbs) ---------------------------
    def get(self, trace_id: str) -> Optional[RequestTrace]:
        return self.traces.get(trace_id)

    def query(self, model: Optional[str] = None,
              tenant: Optional[str] = None,
              slo_miss: Optional[bool] = None,
              error: Optional[bool] = None,
              limit: int = 50) -> list[RequestTrace]:
        """Retained traces, newest first, filtered on root attributes."""
        out: list[RequestTrace] = []
        for tid in reversed(self.traces):
            tr = self.traces[tid]
            a = tr.root.attrs
            if model is not None and a.get("model") != model:
                continue
            if tenant is not None and a.get("tenant") != tenant:
                continue
            if slo_miss is not None and bool(a.get("slo_miss")) is not \
                    slo_miss:
                continue
            if error is not None and (tr.root.status == "error") is not \
                    error:
                continue
            out.append(tr)
            if len(out) >= limit:
                break
        return out

    def critical_path(self, trace: Union[RequestTrace, str]) -> list[Span]:
        if isinstance(trace, str):
            got = self.traces.get(trace)
            if got is None:
                return []
            trace = got
        return critical_path(trace)

    def watch(self, fn: Callable):
        """fn(RequestTrace) per retained trace (AdminClient trace watch)."""
        self._watchers.append(fn)

    def unwatch(self, fn: Callable):
        if fn in self._watchers:
            self._watchers.remove(fn)

    # -- aggregation (MetricsGateway fold) ---------------------------------
    def fold(self, model: str) -> dict:
        """Drain this model's pending span durations into per-kind
        p50/p95/p99 histogram keys (``span_<kind>_p50_ms`` ...) plus the
        window's SLO-miss count and exemplar trace ids — one extra dict
        merged into the scrape's per-config aggregate."""
        out: dict = {}
        for key in sorted(k for k in self._durations if k[0] == model):
            samples = sorted(self._durations.pop(key))
            if not samples:
                continue
            base = f"span_{key[1]}"
            out[f"{base}_count"] = len(samples)
            out[f"{base}_p50_ms"] = _pct(samples, 0.50) * 1e3
            out[f"{base}_p95_ms"] = _pct(samples, 0.95) * 1e3
            out[f"{base}_p99_ms"] = _pct(samples, 0.99) * 1e3
        misses = self._miss_counts.pop(model, 0)
        exemplars = self._exemplars.pop(model, None)
        if misses:
            out["slo_miss_count"] = misses
        if exemplars:
            out["slo_miss_exemplars"] = list(exemplars)
        return out

    # -- diagnostics -------------------------------------------------------
    def stats(self) -> dict:
        return {"enabled": self.enabled, "started": self.started,
                "finished": self.finished_total,
                "retained": self.retained_total,
                "resident": len(self.traces),
                "sampled_out": self.sampled_out,
                "errors": self.errors_total,
                "slo_misses": self.slo_miss_total}

    def forest_digest(self) -> str:
        """Deterministic digest over every retained trace's span tree AND
        its critical path — the tracing analogue of the EventLoop's
        `trace_digest()` for twin-run equality tests.  Request ids come
        from a process-global counter, so (like the loop digest's
        qualname normalisation) trace ids and request_id attributes are
        rebased against the forest's minimum before hashing — twin runs
        in one process must digest identically."""
        h = hashlib.sha256()
        ids = sorted(self.traces)
        rids = [self.traces[t].root.attrs.get("request_id")
                for t in ids]
        base = min((r for r in rids if r is not None), default=0)
        for tid, rid in zip(ids, rids):
            tr = self.traces[tid]
            d = tr.to_dict()
            if rid is not None:
                d["trace_id"] = f"trace-{rid - base:08d}"
                d["spans"][0]["attrs"]["request_id"] = rid - base
            h.update(json.dumps(d, sort_keys=True, default=str).encode())
            h.update("|".join(
                f"{s.name}:{s.start:.9f}:{s.end:.9f}"
                for s in critical_path(tr)).encode())
        return h.hexdigest()


def _pct(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]
