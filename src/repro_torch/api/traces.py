"""Wire views and watch sessions for distributed request traces.

The recording side lives in `repro_torch.core.tracing` (the gateway's
`Tracer`); this module is its API surface — dict wire forms for the
`AdminClient` trace verbs (``traces list / get / critical-path``) and a
`TraceWatch` stream session fanning retained traces out to subscribers,
riding the same `StreamSession` machinery as `TokenStream` and
`DeploymentWatch`.

Like the rest of `repro_torch.api`, nothing here imports
`repro_torch.core`: the functions duck-type over any trace object exposing ``trace_id``,
``root`` and ``spans`` (spans expose ``span_id``/``parent_id``/``name``/
``start``/``end``/``status``/``attrs``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.api.streaming import StreamSession


def span_to_dict(span) -> dict:
    """One span's wire form (OpenTelemetry-shaped flat record)."""
    return {"span_id": span.span_id, "parent_id": span.parent_id,
            "name": span.name, "start": span.start, "end": span.end,
            "status": span.status, "attrs": dict(span.attrs)}


def trace_to_dict(trace) -> dict:
    """Full span-tree wire form (``traces get``)."""
    return {"trace_id": trace.trace_id,
            "spans": [span_to_dict(s) for s in trace.spans]}


def trace_summary(trace) -> dict:
    """One listing row (``traces list``): identity, outcome and where the
    request went, without the full tree."""
    root = trace.root
    a = root.attrs
    return {"trace_id": trace.trace_id,
            "status": root.status,
            "start": root.start,
            "duration": (root.end - root.start)
            if root.end is not None else None,
            "model": a.get("model"),
            "tenant": a.get("tenant"),
            "slo_class": a.get("slo_class"),
            "slo_miss": bool(a.get("slo_miss")),
            "error": a.get("error"),
            "retries": a.get("retries", 0),
            "preemptions": a.get("preemptions", 0),
            "spans": len(trace.spans)}


def critical_path_to_dict(trace, path) -> dict:
    """``traces critical-path`` wire form: the bounding span chain plus
    its coverage of the request's end-to-end latency (a well-formed trace
    tiles the root — coverage ~1.0; less means untraced gaps)."""
    root = trace.root
    e2el = (root.end - root.start) if root.end is not None else None
    segments = [{"name": s.name, "start": s.start, "end": s.end,
                 "duration": s.end - s.start, "attrs": dict(s.attrs)}
                for s in path]
    total = sum(seg["duration"] for seg in segments)
    return {"trace_id": trace.trace_id,
            "segments": segments,
            "path_duration": total,
            "e2el": e2el,
            "coverage": (total / e2el) if e2el else None}


class TraceWatch(StreamSession):
    """Live trace stream (``traces watch``): `subscribe(fn)` receives
    each newly retained trace object; `traces` keeps the history;
    `stop()` closes the session and unsubscribes from the tracer."""

    def __init__(self):
        super().__init__()
        self.traces: list = []

    def _deliver(self, trace):
        if self.closed:
            return
        self.traces.append(trace)
        self._publish(trace)

    def stop(self):
        if not self.closed:
            self._close()
