"""`AdminClient`: the kubectl-shaped facade over the declarative control
plane (`repro_torch.core.deployments`).

Operators (and tests, and benchmarks) manage served models exclusively
through specs and verbs — never by poking Job Workers, Autoscalers or DB
rows:

    admin = AdminClient(control_plane)
    dep = admin.apply(model="mistral-small-24b", replicas=1,
                      min_replicas=1, max_replicas=6, gpus_per_node=2)
    admin.wait(dep.name, "Ready")            # drive the virtual clock
    admin.scale(dep.name, 3)                 # kubectl scale
    watch = admin.watch()                    # kubectl get -w
    watch.subscribe(lambda ev: print(ev.type, ev.name))
    admin.delete(dep.name)

Like `ServingClient` over the Web Gateway, this module is duck-typed over
the plane (anything exposing ``.reconciler``) so `repro_torch.api` never
imports `repro_torch.core`; specs are
`repro_torch.core.deployments.ModelDeploymentSpec`
objects or their dict form (`apply(**fields)` builds the dict for you).

`watch()` returns a `DeploymentWatch` — the same `StreamSession`
subscription machinery that backs `TokenStream`, fanning typed
`WatchEvent`s (ADDED / MODIFIED / SCALED / CONDITION / DELETED) out to any
number of subscribers until `stop()`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.api.alerts import AlertWatch
from repro_torch.api.streaming import StreamSession
from repro_torch.api.traces import (TraceWatch, critical_path_to_dict,
                              trace_summary, trace_to_dict)


@dataclass
class WatchEvent:
    """One entry of the deployment event stream (kubectl get -w line)."""
    type: str      # ADDED | MODIFIED | SCALED | CONDITION | DELETED
    name: str
    t: float       # virtual-clock time
    object: dict   # ModelDeployment.to_dict() snapshot

    def to_dict(self) -> dict:
        return {"type": self.type, "name": self.name, "t": self.t,
                "object": self.object}


class DeploymentWatch(StreamSession):
    """Event-stream session over the reconciler: `subscribe(fn)` receives
    each `WatchEvent`; `events` keeps the full history; `stop()` closes the
    session and unsubscribes from the reconciler."""

    def __init__(self):
        super().__init__()
        self.events: list[WatchEvent] = []

    def _deliver(self, event: dict):
        if self.closed:
            return
        ev = WatchEvent(type=event["type"], name=event["name"],
                        t=event["t"], object=event["object"])
        self.events.append(ev)
        self._publish(ev)

    def stop(self):
        if not self.closed:
            self._close()


class AdminClient:
    """Facade over the plane's `Reconciler`: specs in, deployments and
    watch sessions out."""

    def __init__(self, plane):
        # `plane` is a ControlPlane (or anything exposing .reconciler);
        # passing a Reconciler directly also works.  `.tenancy` (the
        # multi-tenant QoS manager) is optional — the tenant verbs below
        # raise if the plane has none.
        self.reconciler = getattr(plane, "reconciler", plane)
        self.tenancy = getattr(plane, "tenancy", None)
        # repro_torch.core.tracing.Tracer (optional, like tenancy): backs the
        # trace verbs below; raises if the plane records no traces
        self.tracer = getattr(plane, "tracer", None)
        # repro_torch.core.telemetry.TelemetryStore (optional): backs the
        # burn-alert verbs below
        self.telemetry = getattr(plane, "telemetry", None)
        self.loop = getattr(plane, "loop", None) or self.reconciler.loop

    # -- verbs -------------------------------------------------------------
    def apply(self, spec=None, **fields):
        """kubectl apply: create or update a deployment.  Pass a
        `ModelDeploymentSpec`, its dict form, or field keywords."""
        if spec is not None and fields:
            raise TypeError(f"pass either a spec or field keywords, not "
                            f"both (got spec and {sorted(fields)})")
        return self.reconciler.apply(fields if spec is None else spec)

    def get(self, name: str):
        """kubectl get: the `ModelDeployment` (spec + live status), or
        None."""
        return self.reconciler.get(name)

    def list(self) -> list:
        return self.reconciler.list()

    def status(self, name: str) -> Optional[dict]:
        """Wire-form snapshot (`to_dict`) of one deployment."""
        dep = self.reconciler.get(name)
        return None if dep is None else dep.to_dict()

    def scale(self, name: str, replicas: int):
        """kubectl scale: patch spec.replicas within [min, max]."""
        return self.reconciler.scale(name, replicas)

    def delete(self, name: str) -> bool:
        return self.reconciler.delete(name)

    def rollback(self, name: str):
        """kubectl rollout undo: re-apply the deployment's previous spec
        revision (422 when there is none)."""
        return self.reconciler.rollback(name)

    # -- tenant QoS verbs (repro_torch.core.tenancy; docs/tenancy.md) ---------
    def _tenants(self):
        if self.tenancy is None:
            raise TypeError("this control plane has no tenancy manager "
                            "(plane.tenancy); tenant verbs are unavailable")
        return self.tenancy

    def apply_tenant(self, spec=None, **fields):
        """Create or update one tenant's QoS policy.  Pass a `TenantSpec`,
        its dict manifest, or field keywords (``name`` required)."""
        if spec is not None and fields:
            raise TypeError(f"pass either a spec or field keywords, not "
                            f"both (got spec and {sorted(fields)})")
        return self._tenants().apply(fields if spec is None else spec)

    def get_tenant(self, name: str):
        """The tenant's `TenantSpec`, or None (no policy = unlimited)."""
        return self._tenants().get(name)

    def list_tenants(self) -> list:
        return self._tenants().list()

    def delete_tenant(self, name: str) -> bool:
        """Drop the QoS policy (auth row stays; back to defaults)."""
        return self._tenants().delete(name)

    def tenant_usage(self, name: str, since=None, model=None):
        """Aggregated `TenantUsage` from the windowed metering records."""
        return self._tenants().usage(name, since=since, model=model)

    def watch(self) -> DeploymentWatch:
        """kubectl get -w: live event stream until `stop()`."""
        w = DeploymentWatch()
        self.reconciler.watch(w._deliver)
        w.on_done(lambda _s: self.reconciler.unwatch(w._deliver))
        return w

    # -- trace verbs (repro_torch.core.tracing; docs/tracing.md) --------------
    def _tracer(self):
        if self.tracer is None:
            raise TypeError("this control plane has no tracer "
                            "(plane.tracer); trace verbs are unavailable")
        return self.tracer

    def traces(self, model: Optional[str] = None,
               tenant: Optional[str] = None,
               slo_miss: Optional[bool] = None,
               error: Optional[bool] = None, limit: int = 50) -> list[dict]:
        """``traces list``: retained trace summaries, newest first,
        filtered by model / tenant / SLO-miss / error outcome."""
        return [trace_summary(t) for t in self._tracer().query(
            model=model, tenant=tenant, slo_miss=slo_miss, error=error,
            limit=limit)]

    def trace(self, trace_id: str) -> Optional[dict]:
        """``traces get``: one trace's full span tree, or None."""
        t = self._tracer().get(trace_id)
        return None if t is None else trace_to_dict(t)

    def trace_critical_path(self, trace_id: str) -> Optional[dict]:
        """``traces critical-path``: the span chain bounding the
        request's e2el, with per-segment durations and coverage."""
        t = self._tracer().get(trace_id)
        if t is None:
            return None
        return critical_path_to_dict(t, self._tracer().critical_path(t))

    def watch_traces(self) -> TraceWatch:
        """``traces watch``: live stream of retained traces (the same
        `StreamSession` machinery as `watch()`) until `stop()`."""
        w = TraceWatch()
        tracer = self._tracer()
        tracer.watch(w._deliver)
        w.on_done(lambda _s: tracer.unwatch(w._deliver))
        return w

    # -- alert verbs (repro_torch.core.telemetry; docs/observability.md) ------
    def _telemetry(self):
        if self.telemetry is None:
            raise TypeError("this control plane has no telemetry store "
                            "(plane.telemetry); alert verbs are unavailable")
        return self.telemetry

    def alerts(self, model: Optional[str] = None,
               slo_class: Optional[str] = None,
               state: Optional[str] = None) -> list[dict]:
        """``alerts list``: burn-rate alert snapshots — live alerts
        (pending/firing) newest first, then recently resolved ones —
        filtered by model / SLO class / lifecycle state."""
        return self._telemetry().alerts(model=model, slo_class=slo_class,
                                        state=state)

    def watch_alerts(self) -> AlertWatch:
        """``alerts watch``: live stream of alert lifecycle transitions
        (the same `StreamSession` machinery as `watch()`) until
        `stop()`."""
        w = AlertWatch()
        telemetry = self._telemetry()
        telemetry.watch(w._deliver)
        w.on_done(lambda _s: telemetry.unwatch(w._deliver))
        return w

    # -- virtual-clock helpers ---------------------------------------------
    def wait(self, name: str, condition: str = "Ready",
             timeout: float = 600.0, status: bool = True) -> bool:
        """Drive the event loop until `condition` reports `status` (the
        blocking `kubectl wait --for=condition=...` analogue).  Returns
        True if the condition was met within `timeout` virtual seconds."""
        def met() -> bool:
            dep = self.reconciler.get(name)
            if dep is None:
                return False
            cond = dep.status.condition(condition)
            return cond is not None and cond.status is status
        if not met() and self.loop is not None:
            self.loop.run_while(lambda: not met(),
                                max_t=self.loop.now + timeout)
        return met()
