"""SLO burn-rate telemetry: rollup store + multi-window alert evaluator.

PR 9's tracer records *where* latency lives (span histograms, SLO-miss
exemplars) but nothing in the system reacts to attainment itself — the
autoscaler still scales on queue-depth proxies and the gateway admits
every class identically while the error budget burns.  This module is
the Google-SRE answer (multi-window multi-burn-rate alerting, SRE
workbook ch. 5) adapted to the virtual clock:

* `METRIC_REGISTRY` — the single declared namespace of every series key
  the MetricsGateway emits (name, type, label dimensions; ``{pool}`` /
  ``{cls}`` / ``{kind}`` templates expand over the closed vocabularies).
  `ModelDeploymentSpec.alert_rules` metric keys validate against it (a
  typo'd key is a 422 at apply time, not a rule that never fires) and
  repro-lint R6 statically checks every emission site against it.
* `MergeableHistogram` — fixed log2 bucket bounds, so histograms from
  different rollup buckets merge exactly (the property Prometheus
  histograms have and percentile scalars do not).
* `RollupStore` — two ring-buffered resolutions (fine buckets for the
  short alert windows, coarse for the long ones) of per-(model, class)
  good/total/shed counters and per-(model, class, span-kind) duration
  histograms.  Bounded memory by construction: a ring overwrites its
  oldest bucket, nothing is ever appended.
* `TelemetryStore` — the evaluator.  Burn rate = (miss fraction) /
  (1 - objective); an alert *pends* when its short window breaches the
  factor, *fires* when the long window confirms (the multi-window AND
  that kills flappy alerts), and *resolves* when the short window
  recovers (the fast-recovery property).  Firing alerts carry the
  burning span kind (the histogram family with the most accumulated
  time), its pool mapping for the autoscaler, exemplar trace ids, and a
  projected recovery time that becomes the 461 ``retry_after`` when the
  gateway sheds.

The loop closes twice: `SLO_BURN_SCALE_UP` (repro_torch.core.autoscaler)
scales the pool whose spans are burning, and `WebGateway.api_handle`
sheds ``batch`` before ``standard`` before ``interactive`` while a
fast-burn alert fires (``ServiceConfig.slo_shed_enabled``; interactive
is never shed — shedding exists to protect it).

Determinism: recording happens synchronously inside existing control
flow (`Tracer.finish`, the gateway's admission path) and evaluation
inside the MetricsGateway scrape — the store schedules NOTHING on the
EventLoop and adds zero virtual time, so telemetry on/off is
schedule-identical and twin sanitized runs produce bit-identical alert
timelines (`alert_digest`).
"""
from __future__ import annotations

import difflib
import hashlib
import json
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.config import (DEFAULT_SLO_OBJECTIVES, SLO_CLASSES,
                          ServiceConfig)
from repro_torch.core.tracing import SPAN_KINDS

#: span kinds a burn alert attributes blame to (the places capacity or
#: queueing shows up); everything else is constant per-request overhead
BURN_KINDS = ("gateway.queue", "engine.queue", "engine.prefill",
              "engine.decode", "kv.handoff")

#: burning span kind -> autoscaler pool target (None = replica count /
#: the deployment's default pool): decode burn grows the decode pool,
#: prefill burn the prefill pool, queue/handoff burn plain replicas
KIND_POOLS = {"engine.prefill": "prefill", "engine.decode": "decode"}

#: admission-shed priority (lower rank = more latency-sensitive = shed
#: later); interactive is never shed — the point of shedding is to
#: protect it
CLASS_RANK = {"interactive": 0, "standard": 1, "batch": 2}

#: exemplar trace ids retained per (model, class) between alerts
_MAX_EXEMPLARS = 16
#: resolved alerts kept for the admin `alerts` listing
_MAX_RESOLVED = 64

#: The declared namespace of every metric series the MetricsGateway can
#: emit (scrape aggregates, tenant series, tracer folds, telemetry
#: folds).  ``{pool}`` expands over the disagg pools, ``{cls}`` over
#: SLO_CLASSES, ``{kind}`` over SPAN_KINDS.  repro-lint R6 statically
#: checks every emission site against this table and
#: `ModelDeploymentSpec.alert_rules` validates metric keys against it —
#: keep it a PURE dict literal (the R6 checker parses, never imports).
METRIC_REGISTRY = {
    # -- engine scrape aggregates (MetricsGateway.scrape per config) ----
    "n": {"type": "gauge", "labels": ("model",)},
    "queue_time_max": {"type": "gauge", "labels": ("model",)},
    "queue_time_min": {"type": "gauge", "labels": ("model",)},
    "kv_util_avg": {"type": "gauge", "labels": ("model",)},
    "waiting_total": {"type": "gauge", "labels": ("model",)},
    "running_total": {"type": "gauge", "labels": ("model",)},
    "gateway_queued": {"type": "gauge", "labels": ("model",)},
    "tenant_queue_weighted": {"type": "gauge", "labels": ("model",)},
    "prefix_hit_rate": {"type": "gauge", "labels": ("model",)},
    "kv_demotions_total": {"type": "counter", "labels": ("model",)},
    "kv_promotions_total": {"type": "counter", "labels": ("model",)},
    "kv_host_hits_total": {"type": "counter", "labels": ("model",)},
    "kv_shared_hits_total": {"type": "counter", "labels": ("model",)},
    # per-phase pool depths (disaggregated deployments only)
    "queue_time_max_{pool}": {"type": "gauge",
                              "labels": ("model", "pool")},
    "waiting_{pool}": {"type": "gauge", "labels": ("model", "pool")},
    "running_{pool}": {"type": "gauge", "labels": ("model", "pool")},
    "kv_util_{pool}": {"type": "gauge", "labels": ("model", "pool")},
    # -- tracer folds (Tracer.fold, merged into the scrape aggregate) ---
    "span_{kind}_count": {"type": "counter", "labels": ("model", "kind")},
    "span_{kind}_p50_ms": {"type": "histogram",
                           "labels": ("model", "kind")},
    "span_{kind}_p95_ms": {"type": "histogram",
                           "labels": ("model", "kind")},
    "span_{kind}_p99_ms": {"type": "histogram",
                           "labels": ("model", "kind")},
    "slo_miss_count": {"type": "counter", "labels": ("model",)},
    "slo_miss_exemplars": {"type": "exemplars", "labels": ("model",)},
    # -- telemetry folds (TelemetryStore.fold) --------------------------
    "slo_burn_fast": {"type": "gauge", "labels": ("model",)},
    "slo_burn_slow": {"type": "gauge", "labels": ("model",)},
    "slo_burn_firing": {"type": "gauge", "labels": ("model",)},
    "slo_shed_total": {"type": "counter", "labels": ("model",)},
    "slo_burn_fast_{cls}": {"type": "gauge", "labels": ("model", "cls")},
    "slo_burn_slow_{cls}": {"type": "gauge", "labels": ("model", "cls")},
    "slo_attainment_{cls}": {"type": "gauge", "labels": ("model", "cls")},
    # -- per-tenant series (MetricsGateway.scrape tenant snapshots) -----
    "inflight": {"type": "gauge", "labels": ("tenant",)},
    "queued": {"type": "gauge", "labels": ("tenant",)},
    "weight": {"type": "gauge", "labels": ("tenant",)},
    "requests_total": {"type": "counter", "labels": ("tenant",)},
    "failed_total": {"type": "counter", "labels": ("tenant",)},
    "prompt_tokens_total": {"type": "counter", "labels": ("tenant",)},
    "completion_tokens_total": {"type": "counter",
                                "labels": ("tenant",)},
    "rejected_quota_total": {"type": "counter", "labels": ("tenant",)},
}

_TEMPLATE_VARS = {"pool": ("prefill", "decode"), "cls": SLO_CLASSES,
                  "kind": SPAN_KINDS}


def _expand_template(name: str) -> list[str]:
    """Every concrete series name a registry template covers."""
    out = [name]
    for var, values in _TEMPLATE_VARS.items():
        token = "{" + var + "}"
        nxt = []
        for n in out:
            if token in n:
                nxt.extend(n.replace(token, v) for v in values)
            else:
                nxt.append(n)
        out = nxt
    return out


#: every concrete series name the registry declares
KNOWN_METRICS = frozenset(
    name for tmpl in METRIC_REGISTRY for name in _expand_template(tmpl))


def known_metric(name: str) -> bool:
    return name in KNOWN_METRICS


def metric_error(name: str) -> Optional[str]:
    """None when `name` is a declared series, else a field-addressable
    message (the 422 body of an alert-rule metric typo)."""
    if name in KNOWN_METRICS:
        return None
    if name.startswith("span_"):
        return (f"metric {name!r} is not in the telemetry metric registry"
                f" — span-family series are span_<kind>_count/p50_ms/"
                f"p95_ms/p99_ms with kind one of {list(SPAN_KINDS)}")
    close = difflib.get_close_matches(name, sorted(KNOWN_METRICS), n=3)
    hint = f"; did you mean {close}?" if close else ""
    return (f"metric {name!r} is not in the telemetry metric registry "
            f"(repro_torch.core.telemetry.METRIC_REGISTRY){hint}")


# ---------------------------------------------------------------------------
# mergeable histograms + multi-resolution rollup rings
# ---------------------------------------------------------------------------

#: fixed log2-spaced duration bucket upper bounds (seconds): 1 ms .. ~35 min,
#: one overflow bucket past the end.  Shared bounds are what makes two
#: histograms mergeable by elementwise count addition.
HIST_BOUNDS = tuple(0.001 * 2 ** i for i in range(22))


class MergeableHistogram:
    """Counts per fixed bucket + exact sum/count.  `merge` is exact
    (same bounds everywhere); `percentile` returns the upper bound of
    the bucket holding the rank — deterministic and conservative."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts = [0] * (len(HIST_BOUNDS) + 1)
        self.count = 0
        self.sum = 0.0

    def add(self, v: float):
        lo, hi = 0, len(HIST_BOUNDS)
        while lo < hi:                    # bisect over the fixed bounds
            mid = (lo + hi) // 2
            if v <= HIST_BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v

    def merge(self, other: "MergeableHistogram") -> "MergeableHistogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, int(q * self.count + 0.9999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return HIST_BOUNDS[min(i, len(HIST_BOUNDS) - 1)]
        return HIST_BOUNDS[-1]


class _Ring:
    """One rollup resolution: `slots` ring-buffered buckets of
    `resolution` seconds.  A bucket is lazily reset when its slot is
    reused for a newer epoch — no timers, no scheduled maintenance."""

    __slots__ = ("resolution", "slots", "_epochs", "_counts", "_hists")

    def __init__(self, resolution: float, slots: int):
        self.resolution = resolution
        self.slots = slots
        self._epochs = [-1] * slots
        # slot -> {(model, cls): [good, total, shed]}
        self._counts: list[dict] = [{} for _ in range(slots)]
        # slot -> {(model, cls, kind): MergeableHistogram}
        self._hists: list[dict] = [{} for _ in range(slots)]

    def _slot(self, t: float) -> int:
        epoch = int(t // self.resolution)
        i = epoch % self.slots
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            self._counts[i] = {}
            self._hists[i] = {}
        return i

    def record(self, t: float, model: str, cls: str, good: bool,
               shed: bool = False):
        c = self._counts[self._slot(t)].setdefault((model, cls), [0, 0, 0])
        if shed:
            c[2] += 1
            return
        c[0] += int(good)
        c[1] += 1

    def record_span(self, t: float, model: str, cls: str, kind: str,
                    duration: float):
        h = self._hists[self._slot(t)].setdefault(
            (model, cls, kind), MergeableHistogram())
        h.add(duration)

    def _live_slots(self, t0: float, t1: float):
        e0, e1 = int(t0 // self.resolution), int(t1 // self.resolution)
        e0 = max(e0, e1 - self.slots + 1)
        for epoch in range(e0, e1 + 1):
            i = epoch % self.slots
            if self._epochs[i] == epoch:
                yield i

    def counts(self, model: str, cls: str, t0: float,
               t1: float) -> tuple[int, int, int]:
        good = total = shed = 0
        for i in self._live_slots(t0, t1):
            c = self._counts[i].get((model, cls))
            if c is not None:
                good += c[0]
                total += c[1]
                shed += c[2]
        return good, total, shed

    def kind_hist(self, model: str, kind: str, t0: float,
                  t1: float) -> MergeableHistogram:
        """Merged histogram for one span kind across every class."""
        out = MergeableHistogram()
        for i in self._live_slots(t0, t1):
            hists = self._hists[i]
            for cls in SLO_CLASSES:
                h = hists.get((model, cls, kind))
                if h is not None:
                    out.merge(h)
        return out


class RollupStore:
    """Two resolutions of the same stream: the fine ring answers the
    short burn windows exactly, the coarse ring covers the long ones.
    `counts`/`kind_hist` pick the ring by window span."""

    def __init__(self, fine_resolution: float = 5.0, fine_slots: int = 64,
                 coarse_resolution: float = 60.0, coarse_slots: int = 64):
        self.fine = _Ring(fine_resolution, fine_slots)
        self.coarse = _Ring(coarse_resolution, coarse_slots)

    def _ring(self, t0: float, t1: float) -> _Ring:
        span = t1 - t0
        if span <= self.fine.resolution * self.fine.slots:
            return self.fine
        return self.coarse

    def record(self, t, model, cls, good, shed=False):
        self.fine.record(t, model, cls, good, shed)
        self.coarse.record(t, model, cls, good, shed)

    def record_span(self, t, model, cls, kind, duration):
        self.fine.record_span(t, model, cls, kind, duration)
        self.coarse.record_span(t, model, cls, kind, duration)

    def counts(self, model, cls, t0, t1):
        return self._ring(t0, t1).counts(model, cls, t0, t1)

    def kind_hist(self, model, kind, t0, t1):
        return self._ring(t0, t1).kind_hist(model, kind, t0, t1)


# ---------------------------------------------------------------------------
# burn alerts
# ---------------------------------------------------------------------------

@dataclass
class BurnAlert:
    """One (model, class, severity) alert through its lifecycle."""
    model: str
    slo_class: str
    severity: str                  # "fast" | "slow"
    state: str = "pending"         # pending -> firing -> resolved
    pending_at: float = 0.0
    fired_at: Optional[float] = None
    resolved_at: Optional[float] = None
    short_burn: float = 0.0
    long_burn: float = 0.0
    factor: float = 0.0
    windows: tuple = (0.0, 0.0)
    burning_kind: Optional[str] = None
    pool: Optional[str] = None
    exemplars: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return f"slo_burn_{self.severity}:{self.model}:{self.slo_class}"

    def to_dict(self) -> dict:
        return {"name": self.name, "model": self.model,
                "slo_class": self.slo_class, "severity": self.severity,
                "state": self.state, "pending_at": self.pending_at,
                "fired_at": self.fired_at, "resolved_at": self.resolved_at,
                "short_burn": self.short_burn, "long_burn": self.long_burn,
                "factor": self.factor,
                "windows": list(self.windows),
                "burning_kind": self.burning_kind, "pool": self.pool,
                "exemplars": list(self.exemplars)}


class TelemetryStore:
    """Rollups + the multi-window multi-burn-rate evaluator.

    Fed synchronously: `Tracer.finish` calls `observe` per completed
    request (shed requests are excluded — a shed-induced miss must not
    sustain the very alert that sheds), the gateway calls `note_shed`
    per rejection, and the MetricsGateway scrape calls `fold` which runs
    one evaluation pass on the virtual clock.  Nothing here touches the
    EventLoop."""

    def __init__(self, services: Optional[ServiceConfig] = None):
        svc = services or ServiceConfig()
        self.objectives = dict(svc.slo_objectives)
        #: severity -> ((short_window, long_window), factor)
        self.pairs = {"fast": (tuple(svc.burn_fast_window),
                               svc.burn_fast_factor),
                      "slow": (tuple(svc.burn_slow_window),
                               svc.burn_slow_factor)}
        self.min_events = svc.burn_min_events
        self.shed_escalate_after = svc.shed_escalate_after
        self.rollups = RollupStore()
        # (model, cls, severity) -> live BurnAlert (pending or firing)
        self._alerts: dict[tuple, BurnAlert] = {}
        self._resolved: deque = deque(maxlen=_MAX_RESOLVED)
        # (model, cls) -> deque[(trace_id, dominant burn kind)]
        self._exemplars: dict[tuple, deque] = {}
        #: every lifecycle transition, in virtual-time order (the alert
        #: analogue of the EventLoop trace — `alert_digest` hashes it)
        self.alert_log: list[dict] = []
        self.shed_total: dict[str, int] = {}
        self.observed_total = 0
        self._watchers: list[Callable] = []

    # -- feed (Tracer.finish / WebGateway) ------------------------------
    def observe(self, model: str, slo_class: Optional[str], trace,
                slo_miss: bool, error: bool, t: float):
        """One finished request: count attainment, record burn-kind span
        durations, stash an exemplar on a miss.  Shed requests (root
        annotated ``shed=True``) are skipped — they were rejected BY the
        alert and must not feed it."""
        cls = slo_class if slo_class in CLASS_RANK else "standard"
        if trace is not None and trace.root.attrs.get("shed"):
            return
        good = not (slo_miss or error)
        self.observed_total += 1
        self.rollups.record(t, model, cls, good)
        dominant, dom_t = None, 0.0
        if trace is not None:
            totals: dict[str, float] = {}
            for s in trace.spans:
                if s.name in BURN_KINDS and s.end is not None:
                    totals[s.name] = totals.get(s.name, 0.0) \
                        + (s.end - s.start)
            for kind in BURN_KINDS:
                d = totals.get(kind)
                if d is None:
                    continue
                self.rollups.record_span(t, model, cls, kind, d)
                if d > dom_t:
                    dominant, dom_t = kind, d
        if not good:
            ex = self._exemplars.setdefault((model, cls),
                                            deque(maxlen=_MAX_EXEMPLARS))
            ex.append((trace.trace_id if trace is not None else None,
                       dominant))

    def note_shed(self, model: str, slo_class: Optional[str], t: float):
        """One admission-shed rejection (the gateway's 461)."""
        cls = slo_class if slo_class in CLASS_RANK else "standard"
        self.rollups.record(t, model, cls, good=False, shed=True)
        self.shed_total[model] = self.shed_total.get(model, 0) + 1

    # -- burn math -------------------------------------------------------
    def _budget(self, cls: str) -> float:
        return max(1.0 - self.objectives.get(cls, 0.99), 1e-9)

    def burn_rate(self, model: str, cls: str, window: float,
                  now: float) -> float:
        """miss_fraction / error_budget over [now - window, now]; 0.0
        below `min_events` observations (a two-request blip must not
        page)."""
        good, total, _shed = self.rollups.counts(
            model, cls, now - window, now)
        if total < self.min_events:
            return 0.0
        return ((total - good) / total) / self._budget(cls)

    def _burning_kind(self, model: str, window: float,
                      now: float) -> Optional[str]:
        """The span kind with the most accumulated time over the window
        (ties broken by BURN_KINDS order — deterministic)."""
        best, best_t = None, 0.0
        for kind in BURN_KINDS:
            h = self.rollups.kind_hist(model, kind, now - window, now)
            if h.sum > best_t:
                best, best_t = kind, h.sum
        return best

    # -- evaluation (MetricsGateway scrape) ------------------------------
    def _transition(self, alert: BurnAlert, new_state: str, t: float):
        old = alert.state
        alert.state = new_state
        self.alert_log.append(
            {"t": t, "model": alert.model, "slo_class": alert.slo_class,
             "severity": alert.severity, "from": old, "to": new_state})
        snap = alert.to_dict()
        for fn in list(self._watchers):
            fn(snap)

    def _evaluate(self, model: str, now: float) -> dict:
        """One evaluation pass for one model; returns the per-(class,
        severity) (short_burn, long_burn) map the fold reports."""
        burns: dict = {}
        for cls in SLO_CLASSES:
            for severity in ("fast", "slow"):
                (w_short, w_long), factor = self.pairs[severity]
                bs = self.burn_rate(model, cls, w_short, now)
                bl = self.burn_rate(model, cls, w_long, now)
                burns[(cls, severity)] = (bs, bl)
                key = (model, cls, severity)
                alert = self._alerts.get(key)
                breach_s, breach_l = bs >= factor, bl >= factor
                if alert is None:
                    if breach_s:
                        # short window breached: open a pending alert;
                        # it fires only once the long window confirms
                        alert = BurnAlert(
                            model=model, slo_class=cls, severity=severity,
                            pending_at=now, short_burn=bs, long_burn=bl,
                            factor=factor, windows=(w_short, w_long))
                        self._alerts[key] = alert
                        self._transition(alert, "pending", now)
                        if breach_l:
                            self._fire(alert, now)
                    continue
                alert.short_burn, alert.long_burn = bs, bl
                if alert.state == "pending":
                    if not breach_s:
                        # short recovered before the long window ever
                        # confirmed: drop silently back to clear
                        self._transition(alert, "resolved", now)
                        alert.resolved_at = now
                        del self._alerts[key]
                        self._resolved.append(alert)
                    elif breach_l:
                        self._fire(alert, now)
                elif alert.state == "firing" and not breach_s:
                    # the short window is the fast-recovery signal: once
                    # it drains under the factor the page clears even
                    # while the long window still remembers the incident
                    alert.resolved_at = now
                    self._transition(alert, "resolved", now)
                    del self._alerts[key]
                    self._resolved.append(alert)
        return burns

    def _fire(self, alert: BurnAlert, now: float):
        w_long = alert.windows[1]
        alert.fired_at = now
        alert.burning_kind = self._burning_kind(alert.model, w_long, now)
        alert.pool = KIND_POOLS.get(alert.burning_kind)
        ex = self._exemplars.get((alert.model, alert.slo_class), ())
        matching = [tid for tid, kind in ex
                    if tid is not None and kind == alert.burning_kind]
        alert.exemplars = (matching or
                           [tid for tid, _k in ex if tid is not None])[-8:]
        self._transition(alert, "firing", now)

    def projected_recovery(self, alert: BurnAlert, now: float) -> float:
        """Seconds until the alert's short window drains below the
        factor assuming misses stop now — the honest ``retry_after`` for
        a shed 461 (a breached window empties linearly as it slides)."""
        w_short = alert.windows[0]
        b = max(alert.short_burn, alert.factor)
        if b <= 0:
            return 1.0
        return max(1.0, w_short * (1.0 - alert.factor / b))

    # -- control surface -------------------------------------------------
    def fold(self, model: str, now: float) -> dict:
        """Evaluate + report: the telemetry series the MetricsGateway
        stores into the model's scrape aggregate (every key here must be
        emitted via a literal ``agg[...]`` store in metrics_gateway.py —
        repro-lint R4/R6 read those)."""
        burns = self._evaluate(model, now)
        out: dict = {}
        fast_all, slow_all = 0.0, 0.0
        for cls in SLO_CLASSES:
            bs, bl = burns[(cls, "fast")]
            fast = min(bs, bl)       # the multi-window AND as a series
            out[f"slo_burn_fast_{cls}"] = fast
            fast_all = max(fast_all, fast)
            bs, bl = burns[(cls, "slow")]
            slow = min(bs, bl)
            out[f"slo_burn_slow_{cls}"] = slow
            slow_all = max(slow_all, slow)
            w_att = self.pairs["slow"][0][1]
            good, total, _shed = self.rollups.counts(
                model, cls, now - w_att, now)
            out[f"slo_attainment_{cls}"] = (good / total) if total else 1.0
        out["slo_burn_fast"] = fast_all
        out["slo_burn_slow"] = slow_all
        out["slo_burn_firing"] = sum(
            1 for (m, _c, _s), a in self._alerts.items()
            if m == model and a.state == "firing")
        out["slo_shed_total"] = self.shed_total.get(model, 0)
        return out

    def should_shed(self, model: str, slo_class: Optional[str],
                    now: float) -> Optional[float]:
        """While a fast-burn alert fires for `model`: the ``retry_after``
        to shed this request with, or None to admit.  Sheds from the
        bottom of the class ladder (batch first), escalating one class
        per `shed_escalate_after` seconds of sustained firing, and never
        sheds the burning class itself or anything more latency-
        sensitive — load is dropped to protect the classes above it."""
        firing = [a for (m, _c, s), a in self._alerts.items()
                  if m == model and s == "fast" and a.state == "firing"]
        if not firing:
            return None
        protected = min(CLASS_RANK[a.slo_class] for a in firing)
        if protected >= CLASS_RANK["batch"]:
            return None           # batch-only burn: scale up, don't shed
        rank = CLASS_RANK.get(slo_class, CLASS_RANK["standard"])
        first_fired = min(a.fired_at for a in firing)
        levels = 1 + int((now - first_fired) // self.shed_escalate_after)
        # shed the `levels` lowest classes strictly below the protected one
        shed_floor = max(protected + 1,
                         CLASS_RANK["batch"] - (levels - 1))
        if rank < shed_floor:
            return None
        driver = min(firing, key=lambda a: CLASS_RANK[a.slo_class])
        return self.projected_recovery(driver, now)

    def burning_pool(self, model: str) -> Optional[str]:
        """The pool the model's worst firing alert blames (fast beats
        slow) — `SLO_BURN_SCALE_UP`'s ``pool="burning"`` resolution."""
        for severity in ("fast", "slow"):
            for cls in SLO_CLASSES:
                a = self._alerts.get((model, cls, severity))
                if a is not None and a.state == "firing":
                    return a.pool
        return None

    # -- admin surface (AdminClient alerts / watch_alerts) ----------------
    def alerts(self, model: Optional[str] = None,
               slo_class: Optional[str] = None,
               state: Optional[str] = None) -> list[dict]:
        """Live (pending/firing) alerts then recent resolved ones, newest
        transition first, as wire dicts."""
        rows = sorted(self._alerts.values(),
                      key=lambda a: -a.pending_at)
        rows += [a for a in reversed(self._resolved)]
        out = []
        for a in rows:
            if model is not None and a.model != model:
                continue
            if slo_class is not None and a.slo_class != slo_class:
                continue
            if state is not None and a.state != state:
                continue
            out.append(a.to_dict())
        return out

    def watch(self, fn: Callable):
        """fn(alert_dict) per lifecycle transition."""
        self._watchers.append(fn)

    def unwatch(self, fn: Callable):
        if fn in self._watchers:
            self._watchers.remove(fn)

    def stats(self) -> dict:
        return {"observed": self.observed_total,
                "live_alerts": len(self._alerts),
                "transitions": len(self.alert_log),
                "shed_total": sum(self.shed_total.values())}

    def alert_digest(self) -> str:
        """Deterministic digest over the full transition timeline —
        twin sanitized runs must produce identical alert histories at
        identical virtual times (tests/test_telemetry.py)."""
        h = hashlib.sha256()
        for entry in self.alert_log:
            h.update(json.dumps(entry, sort_keys=True).encode())
        return h.hexdigest()
