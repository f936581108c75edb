"""A vLLM server instance inside a Slurm job (the paper's layer 2).

Wraps an LLMEngine and self-schedules its step loop on the event loop:
while there is work, steps run back-to-back, each consuming the model time
given by the executor (roofline simulator or real PyTorch compute). `/health`
returns 200 only once weight loading (est_load_time) has completed —
exactly the signal the Endpoint Worker polls.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.simclock import EventLoop
from repro_torch.engine.engine import LLMEngine
from repro_torch.engine.request import Request, RequestStatus


class VLLMInstance:
    def __init__(self, loop: EventLoop, engine: LLMEngine, *, node: str,
                 port: int, bearer_token: str, model_name: str,
                 load_time: float = 120.0, phase: str = "unified"):
        self.loop = loop
        self.engine = engine
        self.node = node
        self.port = port
        self.bearer_token = bearer_token
        self.model_name = model_name
        self.phase = phase          # unified | prefill | decode pool member
        # fn(req) -> bool, set by the control plane: offered every in-flight
        # request when this instance dies; True = the gateway took the
        # request over (disaggregated transparent retry) and the stream
        # must NOT be failed here
        self.lost_sink = None
        self.alive = True
        self.loaded = False
        # draining: still alive and serving in-flight work, but the Web
        # Gateway must not route NEW requests here (declarative scale-down
        # / rolling update); the Reconciler scancels once the engine idles
        self.draining = False
        self._stepping = False
        loop.call_after(load_time, self._finish_load)

    # -- lifecycle ---------------------------------------------------------
    def _finish_load(self):
        if self.alive:
            self.loaded = True
            self._kick()

    def drain(self):
        """Stop accepting new routed traffic; keep stepping until the
        engine runs dry.  `health()` stays 200 so the Endpoint Worker does
        not reap the rows mid-drain."""
        self.draining = True

    def kill(self):
        """Slurm job cancelled / node failed: in-flight requests are lost —
        unless the gateway's `lost_sink` takes one over (disaggregated
        transparent retry), in which case its stream stays open."""
        self.alive = False
        self.loaded = False
        for seq in list(self.engine.scheduler.running):
            self.engine.scheduler.finish_seq(seq, RequestStatus.FAILED)
            self.engine.metrics.requests_failed += 1
            if not self._offer_lost(seq.req):
                self._fail_stream(seq.req)
        for req in list(self.engine.scheduler.waiting):
            req.status = RequestStatus.FAILED
            self.engine.metrics.requests_failed += 1
            if not self._offer_lost(req):
                self._fail_stream(req)
        self.engine.scheduler.waiting.clear()

    def _offer_lost(self, req: Request) -> bool:
        return self.lost_sink is not None and self.lost_sink(req)

    def _fail_stream(self, req: Request):
        """Deliver a terminal 462 error event on the request's TokenStream
        (if the API layer attached one) so streaming clients see the loss
        instead of waiting forever.  Duck-typed: this layer must not depend
        on repro_torch.api for requests submitted directly."""
        stream = getattr(req.on_token, "__self__", None)
        if stream is None or not hasattr(stream, "fail"):
            return
        from repro_torch.api.errors import error_for_status
        stream.fail(error_for_status(
            462, retry_after=getattr(stream, "retry_after_hint", None),
            message=f"Instance {self.node}:{self.port} terminated "
                    f"mid-request (Slurm job cancelled or node failed)."))

    # -- API surface ---------------------------------------------------------
    def health(self) -> int:
        """GET /health -> HTTP status."""
        return 200 if (self.alive and self.loaded) else 503

    def submit(self, req: Request, bearer: Optional[str] = None) -> int:
        if not self.alive or not self.loaded:
            return 503
        if bearer is not None and bearer != self.bearer_token:
            return 401
        self.engine.add_request(req, self.loop.now)
        self._kick()
        return 200

    def metrics_snapshot(self) -> dict:
        return self.engine.snapshot(self.loop.now)

    # -- step loop -----------------------------------------------------------
    def _kick(self):
        if self._stepping or not (self.alive and self.loaded):
            return
        self._stepping = True
        self.loop.call_after(0.0, self._step)

    def _step(self):
        if not self.alive:
            self._stepping = False
            return
        rep = self.engine.step(self.loop.now)
        if rep.kind == "idle":
            self._stepping = False
            if self.engine.has_work():
                # blocked (e.g. allocator pressure with nothing evictable):
                # back off one scheduler tick rather than spinning
                self.loop.call_after(0.05, self._kick)
            return
        self.loop.call_after(rep.elapsed, self._step)
