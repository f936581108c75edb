"""`ServingClient`: the OpenAI-style facade every entry path goes through.

Examples and benchmarks talk to the cluster exclusively via this client —
typed request schemas in, typed responses / `TokenStream` sessions out,
structured `APIStatusError` on every failure — so the routing, queuing and
autoscaling machinery underneath can evolve without breaking callers
(the decoupling Chat AI and vLLM production-stack get from their
OpenAI-compatible edges).

    client = ServingClient(control_plane, api_key="sk-demo")
    stream = client.chat(model="m", messages=[...], stream=True)
    stream.subscribe(lambda r, tok, t: print(tok, t))
    ...
    pending = client.chat(model="m", messages=[...])
    resp = pending.result()          # drives the virtual clock until done
    resp.usage.completion_tokens

The virtual clock makes non-streaming calls two-phase: submission returns a
`PendingCompletion` immediately; `.result()` advances the event loop until
the stream closes (or use `.response()` after driving the loop yourself).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.api.errors import APIStatusError
from repro_torch.api.schemas import (ChatCompletionRequest, CompletionRequest,
                               Usage)
from repro_torch.api.streaming import TokenStream


class PendingCompletion:
    """Handle for a non-streaming call on the virtual clock."""

    def __init__(self, stream: TokenStream, loop, status: int):
        self.stream = stream
        self.loop = loop
        self.status = status           # 200 forwarded | 202 gateway-queued

    @property
    def request(self):
        return self.stream.req

    @property
    def done(self) -> bool:
        return self.stream.closed

    def response(self):
        """Typed response; raises APIStatusError if the request terminally
        failed (queue TTL expiry, instance death), RuntimeError if still in
        flight."""
        return self.stream.response()

    def result(self, max_wait: float = 600.0):
        """Drive the event loop until the stream closes, then return the
        response (the blocking-HTTP-call analogue)."""
        if not self.stream.closed and self.loop is not None:
            self.loop.run_while(lambda: not self.stream.closed,
                                max_t=self.loop.now + max_wait)
        return self.response()


class MultiPendingCompletion:
    """Handle for an ``n > 1`` fan-out: the client submits one engine
    request per requested choice and aggregates them into a single
    OpenAI-shaped response — choices indexed 0..n-1, prompt tokens counted
    once, completion tokens summed (the OpenAI usage contract)."""

    def __init__(self, streams: list, loop):
        self.streams = streams
        self.loop = loop

    @property
    def done(self) -> bool:
        return all(s.closed for s in self.streams)

    def response(self):
        parts = [s.response() for s in self.streams]   # raises on any error
        choices = [dataclasses.replace(p.choices[0], index=i)
                   for i, p in enumerate(parts)]
        usage = Usage(prompt_tokens=parts[0].usage.prompt_tokens,
                      completion_tokens=sum(p.usage.completion_tokens
                                            for p in parts))
        return dataclasses.replace(parts[0], choices=choices, usage=usage)

    def result(self, max_wait: float = 600.0):
        """Drive the event loop until every choice's stream closes."""
        if not self.done and self.loop is not None:
            self.loop.run_while(lambda: not self.done,
                                max_t=self.loop.now + max_wait)
        return self.response()


class ServingClient:
    """Facade over the Web Gateway: validated schemas in, streams/responses
    out, structured errors raised — never bare int status codes."""

    def __init__(self, plane, api_key: str,
                 default_model: Optional[str] = None):
        # `plane` is a ControlPlane (or anything exposing .web_gateway);
        # passing a WebGateway directly also works.
        self.gateway = getattr(plane, "web_gateway", plane)
        self.loop = getattr(plane, "loop", None) or self.gateway.loop
        self.api_key = api_key
        self.default_model = default_model

    # -- endpoints ---------------------------------------------------------
    def chat(self, request: Optional[ChatCompletionRequest] = None,
             **fields) -> Union[TokenStream, PendingCompletion]:
        """POST /v1/chat/completions."""
        return self._submit(ChatCompletionRequest, request, fields, "chat")

    def completions(self, request: Optional[CompletionRequest] = None,
                    **fields) -> Union[TokenStream, PendingCompletion]:
        """POST /v1/completions."""
        return self._submit(CompletionRequest, request, fields, "completion")

    def try_completions(self, request: Optional[CompletionRequest] = None,
                        on_error=None, **fields):
        """`completions`, but a gateway rejection returns None instead of
        raising (open-loop benchmark drivers drop rejected arrivals);
        `on_error(APIStatusError)` observes the rejection if given."""
        try:
            return self.completions(request, **fields)
        except APIStatusError as e:
            if on_error is not None:
                on_error(e)
            return None

    def submitter(self, on_error=None):
        """(streams, submit) pair for open-loop workload drivers: each
        `submit(wire)` feeds `try_completions` and collects the accepted
        `TokenStream`s — the shared boilerplate of every benchmark/example
        that replays a trace against the gateway."""
        streams = []

        def submit(wire):
            s = self.try_completions(wire, on_error=on_error)
            if s is not None:
                streams.append(s)

        return streams, submit

    # -- plumbing ----------------------------------------------------------
    def _submit(self, cls, request, fields: dict, kind: str):
        if request is None:
            fields.setdefault("model", self.default_model)
            request = cls(**fields)
        elif fields:
            raise TypeError(f"pass either a request object or field "
                            f"keywords, not both (got request and "
                            f"{sorted(fields)})")
        request.validate()                      # raises APIStatusError(422)
        if request.n > 1:
            # fan-out: one engine request per choice (each samples
            # independently — token synthesis keys on the request id).
            # A rejection raises immediately; already-accepted siblings
            # keep streaming and are simply discarded by the caller.
            streams = []
            for _ in range(request.n):
                status, stream, error = self.gateway.api_handle(
                    self.api_key, request.model, request.to_engine_request(),
                    kind=kind)
                if error is not None:
                    raise APIStatusError(error)
                streams.append(stream)
            return MultiPendingCompletion(streams, self.loop)
        ereq = request.to_engine_request()
        status, stream, error = self.gateway.api_handle(
            self.api_key, request.model, ereq, kind=kind)
        if error is not None:
            raise APIStatusError(error)
        if request.stream:
            return stream
        return PendingCompletion(stream, self.loop, status)
