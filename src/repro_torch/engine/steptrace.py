"""Step spans of the port's engine: where the host's time goes inside one
``LLMEngine.step`` and the ``RealExecutor.step`` it calls.

A ``StepTracer`` attached to an engine (``attach``) records one span tree a
step that scheduled work, in the closed vocabulary ``STEP_SPANS``:

    engine.step
      engine.schedule
      executor.step
        executor.prepare     kind (decode | prefill)
        executor.launch      kind
        executor.to_host     kind
      engine.sample

``executor.prepare`` / ``launch`` / ``to_host`` come once a model pass (the
decode batch, each prompt computed); a chunk of a chunked prefill that
computes nothing has none. These spans are apart from the per-request trees
of ``core.tracing`` (``RequestTrace``), whose ``Span`` type they share.

Stamps are ``time.perf_counter_ns()``, read only in this module, each read
with its own R1 suppression. The tracer reads one anchor when it
is made, a (perf_counter_ns, time_ns) pair read back to back, and converts
a stamp to Unix-epoch ns (``epoch_ns``), the clock of ``torch.profiler``'s
kineto events, so that the spans line up with a device trace.

With no tracer attached (``engine.tracer is None``, the default, and always
on the simulator) every span site costs one ``is None`` test: no clock
read and no allocation. Spans never feed back into scheduling.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

from repro_torch.core.tracing import Span

#: the closed span vocabulary (docs/tracing.md, "Engine step spans")
STEP_SPANS = ("engine.step", "engine.schedule", "executor.step",
              "executor.prepare", "executor.launch", "executor.to_host",
              "engine.sample")

#: spans held by default: about 7 a step, so some two hours of steps at
#: ten steps a second
CAPACITY = 1 << 19


class StepTracer:
    """A bounded ring of step spans. When the ring is full the oldest span
    goes and ``dropped`` counts it."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._open: list[Span] = []    # open spans, innermost last
        self._next_id = 0
        # repro-lint: disable-next-line=R1(the anchor, read once when a tracer is made; the simulator makes none, and spans never feed back into scheduling)
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def now(self) -> int:
        """A stamp: the start of a phase."""
        # repro-lint: disable-next-line=R1(read only while a tracer is attached; the simulator attaches none, and spans never feed back into scheduling)
        return time.perf_counter_ns()

    def epoch_ns(self, stamp: int) -> int:
        """A stamp on the Unix-epoch clock of ``torch.profiler``'s events."""
        return stamp - self.anchor[0] + self.anchor[1]

    def _add(self, name: str, start: int, attrs: dict) -> Span:
        parent = self._open[-1].span_id if self._open else None
        s = Span(self._next_id, parent, name, start, attrs)
        self._next_id += 1
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)
        return s

    def begin(self, start: int):
        """Open a step's ``engine.step`` root. Spans left open by a step
        that raised are closed at ``start`` with status ``error``."""
        while self._open:
            self._open.pop().close(start, status="error")
        self._open.append(self._add("engine.step", start, {}))

    def open(self, name: str, start: int, **attrs):
        """Open a child of the innermost open span."""
        self._open.append(self._add(name, start, attrs))

    def close(self, **attrs) -> int:
        """Close the innermost open span now; returns the end stamp."""
        # repro-lint: disable-next-line=R1(read only while a tracer is attached; the simulator attaches none, and spans never feed back into scheduling)
        end = time.perf_counter_ns()
        self._open.pop().close(end, **attrs)
        return end

    def span(self, name: str, start: int, **attrs) -> int:
        """Record a closed child of the innermost open span, from ``start``
        to now; returns the end stamp (the next phase's start)."""
        # repro-lint: disable-next-line=R1(read only while a tracer is attached; the simulator attaches none, and spans never feed back into scheduling)
        end = time.perf_counter_ns()
        self._add(name, start, attrs).end = end
        return end

    def to_dicts(self) -> list:
        """The spans held, oldest first, stamps on the Unix-epoch clock in
        ns (``end`` None while open)."""
        out = []
        for s in self.spans:
            d = s.to_dict()
            d["start"] = self.epoch_ns(s.start)
            if s.end is not None:
                d["end"] = self.epoch_ns(s.end)
            out.append(d)
        return out


def attach(engine, tracer: Optional[StepTracer]):
    """Record ``engine``'s steps into ``tracer`` (``None`` detaches).
    Returns the tracer."""
    engine.tracer = tracer
    engine.executor.tracer = tracer
    return tracer


def detach(engine):
    attach(engine, None)
