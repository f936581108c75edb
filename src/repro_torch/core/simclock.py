"""Discrete-event simulation clock for the control plane.

Every microservice of the paper (Job Worker loop every 15 s, Endpoint Worker
health polls, Prometheus scrapes, Grafana alert evaluation, vLLM engine
steps, network hops) is an event on this loop, so multi-hour autoscaling
scenarios run in milliseconds of wall time and are fully deterministic.

That determinism claim is load-bearing (every A/B comparison in
benchmarks/ rests on it), so it is mechanically enforced rather than
assumed: the JAX package's ``repro.analysis`` lints these modules (this
file is a copy of its ``core/simclock.py``) for wall-clock and
unseeded-randomness leaks statically, and `TracingEventLoop` (the
opt-in sanitizer mode below) verifies it dynamically — two runs of the
same scenario must produce the same trace digest, bit for bit.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(order=True)
class _Event:
    at: float
    seq: int
    fn: Callable = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class PeriodicHandle:
    """Cancellation handle returned by `EventLoop.every`.

    `stop()` cancels the pending tick and prevents any rechain, so a
    periodic service (Reconciler, MetricsGateway scrape, Autoscaler
    evaluation) can be torn down instead of re-arming itself forever."""

    __slots__ = ("_loop", "_pending", "stopped")

    def __init__(self, loop: "EventLoop"):
        self._loop = loop
        self._pending: Optional[_Event] = None
        self.stopped = False

    def stop(self):
        self.stopped = True
        if self._pending is not None:
            self._loop.cancel(self._pending)
            self._pending = None


class EventLoop:
    def __init__(self):
        self.now = 0.0
        self._heap: list[_Event] = []
        self._counter = itertools.count()

    def call_at(self, at: float, fn: Callable) -> _Event:
        ev = _Event(max(at, self.now), next(self._counter), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def call_after(self, delay: float, fn: Callable) -> _Event:
        return self.call_at(self.now + delay, fn)

    def every(self, period: float, fn: Callable,
              start: Optional[float] = None) -> PeriodicHandle:
        """Periodic task; fn(now) each tick.  Returns a `PeriodicHandle`
        whose `stop()` cancels the pending tick and stops the rechain."""
        first = self.now + period if start is None else start
        handle = PeriodicHandle(self)

        def tick():
            if handle.stopped:
                return
            fn(self.now)
            # fn may have called handle.stop(); a stopped task must not
            # re-arm itself
            if not handle.stopped:
                handle._pending = self.call_at(self.now + period, tick)

        # the sanitizer trace records callback qualnames; name the tick
        # after the real callback so traces read "Reconciler.reconcile
        # [every]" instead of an anonymous closure
        tick.__qualname__ = getattr(fn, "__qualname__", repr(fn)) + " [every]"
        handle._pending = self.call_at(first, tick)
        return handle

    def cancel(self, ev: _Event):
        ev.cancelled = True

    # -- run loop ----------------------------------------------------------
    def _step_one(self):
        """Pop and execute the single earliest event (sanitizer hook)."""
        ev = heapq.heappop(self._heap)
        self.now = ev.at
        if not ev.cancelled:
            ev.fn()

    def run_until(self, t: float, max_events: int = 10_000_000):
        n = 0
        while self._heap and self._heap[0].at <= t and n < max_events:
            self._step_one()
            n += 1
        self.now = max(self.now, t)
        if n >= max_events:
            raise RuntimeError("event budget exhausted (livelock?)")

    def run_while(self, cond: Callable[[], bool], max_t: float,
                  max_events: int = 10_000_000):
        n = 0
        while self._heap and cond() and self.now < max_t and n < max_events:
            self._step_one()
            n += 1
        if n >= max_events:
            raise RuntimeError("event budget exhausted (livelock?)")


# ---------------------------------------------------------------------------
# sanitizer mode (opt-in; ClusterSpec.sanitize=True or construct directly)
# ---------------------------------------------------------------------------

class ReentrantRunError(RuntimeError):
    """A callback re-entered `run_until`/`run_while` on its own loop —
    nested pumping reorders the heap relative to a single-pump run."""


class HeapTamperError(RuntimeError):
    """An in-flight callback mutated the event heap through something
    other than `call_at`/`call_after`/`every`/`cancel`."""


def _callback_qualname(fn: Callable) -> str:
    """Stable, id-free name of a scheduled callback for the trace digest."""
    inner = getattr(fn, "__func__", fn)
    return getattr(inner, "__qualname__", None) or repr(type(fn).__name__)


def _callback_owners(fn: Callable) -> frozenset:
    """ids of the mutable objects a callback closes over (bound-method
    receiver + captured closure cells).  Two same-timestamp events whose
    owner sets intersect touch the same state, so their result depends on
    heap insertion order — the tie-order race the sanitizer flags."""
    owners = set()
    receiver = getattr(fn, "__self__", None)
    if receiver is not None:
        owners.add(id(receiver))
    for cell in getattr(fn, "__closure__", None) or ():
        obj = cell.cell_contents
        # immutables cannot race; shared mutable captures can
        if not isinstance(obj, (int, float, complex, str, bytes, bool,
                                tuple, frozenset, type(None))):
            owners.add(id(obj))
    return frozenset(owners)


class TracingEventLoop(EventLoop):
    """Instrumented `EventLoop` for determinism verification (sanitizer
    mode).  Per executed event it folds ``(seq, sim-time, callback
    qualname)`` into a rolling SHA-256 — `trace_digest()` — so two runs of
    the same scenario can be compared bit-for-bit.  It additionally
    detects, at runtime:

    * **tie-order races** — consecutive same-timestamp events whose
      callbacks close over overlapping mutable state (recorded in
      `tie_collisions`; the outcome is still deterministic through the
      seq tiebreaker, but it *depends on scheduling order*, which is what
      the diagnostic surfaces);
    * **re-entrant pumping** — a callback calling `run_until`/`run_while`
      on its own loop (`ReentrantRunError`);
    * **heap tampering** — a callback mutating `_heap` other than through
      the scheduling API (`HeapTamperError`).
    """

    #: cap the per-run collision list; the count keeps incrementing
    MAX_TIE_COLLISIONS = 1000

    def __init__(self):
        super().__init__()
        self._sha = hashlib.sha256()
        self.events_run = 0
        self.callback_counts: dict[str, int] = {}
        self.tie_collisions: list[tuple] = []   # (at, qualname_a, qualname_b)
        self.tie_collision_count = 0
        self._running = False
        self._scheduled = 0                      # live heap-entry count
        self._prev: Optional[tuple] = None       # (at, owners, qualname)

    # -- bookkeeping hooks -------------------------------------------------
    def call_at(self, at: float, fn: Callable) -> _Event:
        ev = super().call_at(at, fn)
        self._scheduled += 1
        return ev

    def trace_digest(self) -> str:
        return self._sha.hexdigest()

    def _step_one(self):
        ev = heapq.heappop(self._heap)
        self._scheduled -= 1
        self.now = ev.at
        if ev.cancelled:
            return
        qual = _callback_qualname(ev.fn)
        self.events_run += 1
        self.callback_counts[qual] = self.callback_counts.get(qual, 0) + 1
        self._sha.update(f"{ev.seq}|{ev.at!r}|{qual}\n".encode())
        owners = _callback_owners(ev.fn)
        if self._prev is not None and self._prev[0] == ev.at \
                and owners and not owners.isdisjoint(self._prev[1]):
            self.tie_collision_count += 1
            if len(self.tie_collisions) < self.MAX_TIE_COLLISIONS:
                self.tie_collisions.append((ev.at, self._prev[2], qual))
        self._prev = (ev.at, owners, qual)
        ev.fn()
        if len(self._heap) != self._scheduled:
            raise HeapTamperError(
                f"callback {qual} mutated the event heap directly "
                f"({len(self._heap)} entries, {self._scheduled} scheduled); "
                f"use call_at/call_after/every/cancel")

    # -- re-entrancy guard -------------------------------------------------
    def run_until(self, t: float, max_events: int = 10_000_000):
        if self._running:
            raise ReentrantRunError(
                "run_until called from inside an event callback")
        self._running = True
        try:
            super().run_until(t, max_events)
        finally:
            self._running = False

    def run_while(self, cond: Callable[[], bool], max_t: float,
                  max_events: int = 10_000_000):
        if self._running:
            raise ReentrantRunError(
                "run_while called from inside an event callback")
        self._running = True
        try:
            super().run_while(cond, max_t, max_events)
        finally:
            self._running = False
