"""Request/response data model for the serving engine (OpenAI-shaped).

Mirrors the Web Gateway's strongly-typed request validation (paper §3.1.2):
requests are validated once at the gateway, then flow to a vLLM-analogue
engine which tracks per-request lifecycle timestamps used by the Table-1
metrics (TTFT / E2EL / TPOT) and by the queue-time autoscaler (§3.3).
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Callable, Optional


class RequestStatus(enum.Enum):
    WAITING = "waiting"        # FCFS queue (vLLM admission)
    RUNNING = "running"        # holds decode slot + KV blocks
    PREEMPTED = "preempted"    # evicted under memory pressure, re-queued
    MIGRATING = "migrating"    # prefill done, KV handoff to the decode pool
    FINISHED = "finished"
    FAILED = "failed"


class SamplingValidationError(ValueError):
    """Validation failure carrying the offending field name, so the API
    layer can surface a structured 422 error object with ``param`` set."""

    def __init__(self, param: str, message: str):
        self.param = param
        super().__init__(message)


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0             # 0 = disabled
    top_p: float = 1.0
    max_new_tokens: int = 128
    # benchmark mode: stop exactly at target_output_len (BurstGPT replay)
    target_output_len: Optional[int] = None
    seed: int = 0
    stop_token: Optional[int] = None

    def validate(self):
        """Gateway-side strong typing/validation (paper: 'request properties
        are strongly typed and validated')."""
        if not isinstance(self.temperature, (int, float)) \
                or isinstance(self.temperature, bool) \
                or not (0.0 <= self.temperature <= 2.0):
            raise SamplingValidationError(
                "temperature", f"temperature {self.temperature!r} must be a "
                               f"number in [0, 2]")
        if not isinstance(self.top_p, (int, float)) \
                or isinstance(self.top_p, bool) \
                or not (0.0 < self.top_p <= 1.0):
            raise SamplingValidationError(
                "top_p", f"top_p {self.top_p!r} must be a number in (0, 1]")
        if type(self.top_k) is not int or self.top_k < 0:
            raise SamplingValidationError(
                "top_k", f"top_k {self.top_k!r} must be a non-negative int")
        if type(self.max_new_tokens) is not int or self.max_new_tokens < 1:
            raise SamplingValidationError(
                "max_new_tokens",
                f"max_new_tokens {self.max_new_tokens!r} must be an int >= 1")
        if self.target_output_len is not None and (
                type(self.target_output_len) is not int
                or self.target_output_len < 1):
            raise SamplingValidationError(
                "target_output_len",
                f"target_output_len {self.target_output_len!r} must be an "
                f"int >= 1 (or None)")
        if type(self.seed) is not int:
            raise SamplingValidationError(
                "seed", f"seed {self.seed!r} must be an int")
        if self.stop_token is not None and type(self.stop_token) is not int:
            raise SamplingValidationError(
                "stop_token",
                f"stop_token {self.stop_token!r} must be an int (or None)")


@dataclass
class RequestMetrics:
    arrival_time: float = 0.0          # enqueue at the FIRST engine
    gateway_time: float = 0.0          # arrival at the web gateway
    # enqueue at the CURRENT engine: a disaggregated request is enqueued
    # twice (prefill hop, decode hop); the scheduler's queue-time signal
    # must measure the local wait, while ttft/e2el keep the original arrival
    last_enqueue_time: Optional[float] = None
    first_scheduled_time: Optional[float] = None
    # admission at the CURRENT engine (stamped on every hop, unlike
    # first_scheduled_time which keeps the first admission for ttft)
    last_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # seconds spent moving KV blocks between phase pools (disaggregation)
    kv_transfer_time: float = 0.0
    preemptions: int = 0
    # token accounting recorded by the engine at finish; the API layer's
    # Usage block is built from these (OpenAI usage.prompt/completion_tokens)
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def queue_time(self) -> Optional[float]:
        """GLOBAL first-admission wait: first scheduling anywhere minus the
        original arrival.  On a disaggregated request this is the prefill
        hop's wait only — per-hop signals must use `local_queue_time`."""
        if self.first_scheduled_time is None:
            return None
        return self.first_scheduled_time - self.arrival_time

    @property
    def local_queue_time(self) -> Optional[float]:
        """Wait in the CURRENT engine's queue: last admission minus last
        enqueue.  This is the unambiguous per-hop signal — on the decode
        hop of a disaggregated request, `queue_time` still reports the
        prefill hop's wait while this reports the decode-local one."""
        if self.last_scheduled_time is None:
            return None
        return self.last_scheduled_time - (
            self.last_enqueue_time if self.last_enqueue_time is not None
            else self.arrival_time)

    def waited(self, now: float) -> float:
        """Time spent so far in the current engine's queue (the
        scheduler's queue-time autoscaling signal; explicitly local)."""
        return now - (self.last_enqueue_time
                      if self.last_enqueue_time is not None
                      else self.arrival_time)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def e2el(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def tpot(self, output_len: int) -> Optional[float]:
        """Paper eq. (1): tpot = (e2el - ttft) / (output_len - 1)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if output_len <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (output_len - 1)


_REQUEST_COUNTER = [0]


@dataclass
class Request:
    prompt_tokens: list
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: int = field(default_factory=lambda: _next_id())
    model: str = ""
    # multi-turn chat / tenant key used by session-affinity routing; None
    # for one-shot requests (router falls back to round-robin)
    session_id: Optional[str] = None
    # multi-agent workflow key (one agent pipeline sharing a growing
    # context): workflow-affinity routing pins every stage of a workflow
    # to the same instance so the shared-prefix KV is reused across
    # agents; None when the request is not part of a workflow
    workflow_id: Optional[str] = None
    # wire-level scheduling hint; orders requests WITHIN a tenant in the
    # gateway queue (across tenants, weighted fair queuing rules — see
    # repro.core.tenancy)
    priority: int = 0
    # request SLO class (config.SLO_CLASSES): the latency-target tier the
    # slo_cost router scores against and the gateway queue orders by;
    # validated at the wire layer (422 on unknown classes)
    slo_class: str = "standard"
    # authenticated tenant, stamped by the Web Gateway after the bearer-
    # token lookup: the WFQ bucket key, the usage-metering account and the
    # session-affinity namespace (never client-supplied)
    tenant: Optional[str] = None
    status: RequestStatus = RequestStatus.WAITING
    output_tokens: list = field(default_factory=list)
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    # streaming callback: fn(request, token_id, now) — the engine calls this
    # per generated token, matching the paper's streaming benchmark setup
    on_token: Optional[Callable] = None
    # disaggregated serving (repro.core.disagg): the KVHandoff produced by
    # the prefill hop and consumed by the decode hop, and the number of
    # times the request was transparently restarted after losing its
    # assigned instance mid-stream
    handoff: Optional[object] = None
    disagg_retries: int = 0
    # distributed tracing (repro.core.tracing.RequestTrace), stamped by
    # the Web Gateway's Tracer; engine code only duck-types it (the
    # engine layer must not import core/) and guards on `is not None`
    trace: Optional[object] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def output_len(self) -> int:
        return len(self.output_tokens)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.output_len

    def target_len(self) -> int:
        t = self.sampling.target_output_len
        return t if t is not None else self.sampling.max_new_tokens

    def is_finished(self, token: Optional[int] = None) -> bool:
        if self.output_len >= self.target_len():
            return True
        stop = self.sampling.stop_token
        return (stop is not None and token is not None and token == stop
                and self.sampling.target_output_len is None)

    def finish_reason(self, token: Optional[int] = None) -> Optional[str]:
        """OpenAI-style reason matching is_finished (None while running).
        The single source of truth consumed by the API layer's streams —
        new finish conditions must be added here, next to is_finished."""
        stop = self.sampling.stop_token
        if (stop is not None and token is not None and token == stop
                and self.sampling.target_output_len is None):
            return "stop"
        if self.output_len >= self.target_len():
            return "length"
        return None


def _next_id() -> int:
    _REQUEST_COUNTER[0] += 1
    return _REQUEST_COUNTER[0]
