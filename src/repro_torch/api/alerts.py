"""Watch sessions for SLO burn-rate alerts.

The evaluation side lives in `repro_torch.core.telemetry` (the
`TelemetryStore` the MetricsGateway scrape drives); this module is its
API surface — an `AlertWatch` stream session fanning alert lifecycle
transitions out to subscribers, riding the same `StreamSession`
machinery as `TokenStream`, `DeploymentWatch` and `TraceWatch`.

Like the rest of `repro_torch.api`, nothing here imports
`repro_torch.core`: the store delivers plain wire dicts (`BurnAlert.to_dict` snapshots — one
per pending/firing/resolved transition), so the watch is already in
wire form.
"""
from __future__ import annotations

from repro_torch.api.streaming import StreamSession


class AlertWatch(StreamSession):
    """Live alert stream (``alerts watch``): `subscribe(fn)` receives
    one alert snapshot dict per lifecycle transition (pending → firing →
    resolved); `alerts` keeps the history; `stop()` closes the session
    and unsubscribes from the telemetry store."""

    def __init__(self):
        super().__init__()
        self.alerts: list[dict] = []

    def _deliver(self, alert: dict):
        if self.closed:
            return
        self.alerts.append(alert)
        self._publish(alert)

    def stop(self):
        if not self.closed:
            self._close()
