"""The program's own step spans (``repro_torch.engine.steptrace``) on the
harness's timeline, for the readers of the host's phases inside a step.

``attach`` puts a ``StepTracer`` on an engine before its window; after the
window ``window_spans`` turns what it recorded into ``StepSpans``,
one a step that started inside the window, in seconds from the window's
start on the harness's clock: the tracer stamps ``time.perf_counter_ns``,
the harness reads ``time.perf_counter``, one clock. A reader finds them as
``win.spans`` and reads nothing (``None``) where a window has none.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StepSpans:
    """One ``engine.step`` span and every span under it, as (name, start,
    end, attrs) in start order."""
    start: float
    end: float
    attrs: dict
    spans: list = field(default_factory=list)

    def of(self, name: str, kind: str | None = None) -> list:
        return [s for s in self.spans if s[0] == name
                and (kind is None or s[3].get("kind") == kind)]

    def total(self, name: str, kind: str | None = None) -> float:
        return sum(b - a for _, a, b, _ in self.of(name, kind))

    @property
    def decode_only(self) -> bool:
        """A decode pass and no prefill computed, as ``decode_step_ms``
        counts a step."""
        return bool(self.of("executor.launch", "decode")) \
            and not self.of("executor.launch", "prefill")


def attach(engine):
    """A ``StepTracer`` attached to ``engine``."""
    from repro_torch.engine import steptrace
    return steptrace.attach(engine, steptrace.StepTracer())


def window_spans(tracer, t_start: float, seconds: float) -> list:
    """The closed step trees of ``tracer`` whose ``engine.step`` started in
    [0, ``seconds``) from ``t_start`` (``time.perf_counter`` seconds)."""
    steps, by_id = [], {}
    for s in tracer.spans:
        if s.end is None:
            continue
        a, b = s.start / 1e9 - t_start, s.end / 1e9 - t_start
        if s.parent_id is None:
            if s.name == "engine.step" and 0 <= a < seconds:
                by_id[s.span_id] = step = StepSpans(a, b, s.attrs)
                steps.append(step)
            continue
        step = by_id.get(s.parent_id)
        if step is not None:
            by_id[s.span_id] = step
            step.spans.append((s.name, a, b, s.attrs))
    return steps


def spans(win):
    """The window's step spans, or ``None``."""
    return getattr(win, "spans", None) or None
