"""SSE-analogue streaming sessions (`TokenStream`).

Replaces the Web Gateway's ad-hoc `req.on_token` monkey-patching: a
`TokenStream` installs itself on the engine request exactly once and fans
tokens out to any number of client subscribers, while the gateway *rebinds*
(not re-wraps) the per-dispatch state — the endpoint finish hook for the
router's `note_finish` and the response-hop transport delay — on every
dispatch attempt.  Rebinding is what fixes the double-wrap hazard on queue
re-dispatch: a second dispatch replaces the previous hook and advances a
dispatch epoch, so a stale dispatch's failure (`fail(..., epoch=...)`)
cannot clobber a live retry.

Terminal delivery is guaranteed: a stream closes with either a
``finish_reason`` ("stop" / "length") or a structured `APIError`
("error") — queue-TTL expiry and instance death both surface here instead
of leaving the caller hanging on a 202.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.api.errors import APIError, APIStatusError
from repro_torch.api.schemas import (ChatChoice, ChatCompletionChunk,
                               ChatCompletionResponse, ChatMessage,
                               ChunkChoice, ChunkDelta, CompletionChoice,
                               CompletionResponse, Usage)
from repro_torch.engine.request import Request


@dataclass
class TokenEvent:
    """One streamed token as the client observed it (post response-hop)."""
    token: int
    t: float
    index: int


class StreamSession:
    """Subscription core shared by every SSE-analogue session: fan-out to
    any number of subscribers, one-shot done callbacks, terminal close.
    `TokenStream` (serving) and the admin API's `DeploymentWatch`
    (`repro_torch.api.admin`) both ride on this."""

    def __init__(self):
        self.closed = False
        self._subs: list[Callable] = []
        self._done_subs: list[Callable] = []

    def subscribe(self, fn: Callable) -> Callable:
        """fn(*event args) per published event."""
        self._subs.append(fn)
        return fn

    def on_done(self, fn: Callable) -> Callable:
        """fn(session) once, at terminal close."""
        if self.closed:
            fn(self)
        else:
            self._done_subs.append(fn)
        return fn

    def _publish(self, *args):
        for fn in list(self._subs):
            fn(*args)

    def _close(self):
        self.closed = True
        done, self._done_subs = self._done_subs, []
        for fn in done:
            fn(self)


class TokenStream(StreamSession):
    """One streaming session bound to one engine request."""

    def __init__(self, req: Request, model: str = "", kind: str = "chat"):
        super().__init__()
        self.req = req
        self.model = model or req.model or ""
        self.kind = kind                       # "chat" | "completion"
        self.id = f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-" \
                  f"{req.request_id}"
        self.created = req.metrics.gateway_time
        self.events: list[TokenEvent] = []
        self.error: Optional[APIError] = None
        self.finish_reason: Optional[str] = None
        self.transport_delay = 0.0             # gateway response hop
        # stamped by the gateway at dispatch: the retry hint any terminal
        # 461/462 failure of this stream should carry (queue TTL / cooldown)
        self.retry_after_hint: Optional[float] = None
        self.dispatch_epoch = 0
        self._finish_hook: Optional[Callable] = None
        req.on_token = self._emit              # single install, ever

    # -- attachment --------------------------------------------------------
    @classmethod
    def ensure(cls, req: Request, model: str = "",
               kind: str = "chat") -> "TokenStream":
        """Return the request's stream, creating it on first contact.  A
        pre-set plain `on_token` callback (legacy clients) is folded in as
        the first subscriber and keeps its exact pre-redesign timestamps
        (engine time + one response hop)."""
        owner = getattr(req.on_token, "__self__", None)
        if isinstance(owner, cls):
            return owner
        legacy_cb = req.on_token
        stream = cls(req, model, kind)
        if legacy_cb is not None:
            stream._subs.append(legacy_cb)
        return stream

    # subscribe(fn): fn(request, token_id, t_client) per streamed token;
    # on_done(fn): fn(stream) once at terminal close (finish OR error) —
    # both inherited from StreamSession.

    # -- gateway side ------------------------------------------------------
    def bind(self, finish_hook: Optional[Callable],
             transport_delay: float = 0.0) -> int:
        """Called by the gateway on every dispatch attempt: REPLACES the
        per-dispatch state instead of wrapping callbacks.  Returns the new
        dispatch epoch; a failure from an earlier dispatch must present its
        epoch to `fail` and is ignored once a newer dispatch exists.  A
        retry of a previously failed request reopens the stream."""
        self.dispatch_epoch += 1
        self._finish_hook = finish_hook
        self.transport_delay = transport_delay
        if self.closed and self.error is not None:
            self.closed = False
            self.error = None
            self.finish_reason = None
        return self.dispatch_epoch

    def restart(self):
        """Discard buffered token events for a transparent re-run of the
        whole request (disaggregated instance-loss retry): the regenerated
        sequence becomes the stream's content, so the terminal views
        (`response()` / `chunks()`) describe exactly the completion the
        retry delivered — never pre-crash tokens followed by a second full
        copy.  Live subscribers see the tokens stream again, like an
        engine-side preemption recompute."""
        self.events = []

    def release_dispatch(self):
        """Release the current dispatch's endpoint slot (fires the finish
        hook once) WITHOUT closing the stream — used by two-hop flows
        (disaggregated prefill handoff) where the request leaves one
        instance mid-stream and will be re-dispatched to another."""
        hook, self._finish_hook = self._finish_hook, None
        if hook is not None:
            hook(self.req)

    def fail(self, error: APIError, epoch: Optional[int] = None) -> bool:
        """Deliver a terminal error event (queue expiry, dead instance,
        gateway rejection).  No-op if already closed or if `epoch` is stale
        (the request was since re-dispatched elsewhere)."""
        if self.closed:
            return False
        if epoch is not None and epoch != self.dispatch_epoch:
            return False
        self.error = error
        self.finish_reason = "error"
        if self._finish_hook is not None:
            # release the dispatched endpoint's router slot (note_finish)
            # just as a normal finish would — dead-instance/expiry failures
            # must not leak LeastLoaded in-flight counts
            self._finish_hook(self.req)
        self._close()
        return True

    @property
    def ok(self) -> bool:
        """Closed successfully: terminal, all tokens delivered, no error."""
        return self.closed and self.error is None

    # -- engine side (installed as req.on_token) ---------------------------
    def _emit(self, r: Request, token: int, t: float):
        if self.closed:
            return
        t_client = t + self.transport_delay
        self.events.append(TokenEvent(token=token, t=t_client,
                                      index=len(self.events)))
        self._publish(r, token, t_client)
        reason = r.finish_reason(token)
        if reason is not None:
            self.finish_reason = reason
            if self._finish_hook is not None:
                self._finish_hook(r)
            self._close()

    # -- wire views --------------------------------------------------------
    @property
    def output_tokens(self) -> list:
        return [e.token for e in self.events]

    def chunks(self) -> list:
        """The streamed `ChatCompletionChunk` deltas, one per token event.
        On a successful close the final chunk carries finish_reason and the
        Usage block; a stream closed by an error ends with an extra empty
        terminal chunk marked finish_reason="error" (terminal delivery is
        guaranteed in the chunk view too)."""
        out = []
        n = len(self.events)
        done = self.closed and self.error is None
        for e in self.events:
            last = done and e.index == n - 1
            out.append(ChatCompletionChunk(
                id=self.id, model=self.model, created=e.t,
                choices=[ChunkChoice(
                    index=0,
                    delta=ChunkDelta(content=[e.token],
                                     role="assistant" if e.index == 0
                                     else None),
                    finish_reason=self.finish_reason if last else None)],
                usage=Usage.from_request(self.req) if last else None))
        if self.closed and self.error is not None:
            out.append(ChatCompletionChunk(
                id=self.id, model=self.model,
                created=self.events[-1].t if self.events else self.created,
                choices=[ChunkChoice(index=0, delta=ChunkDelta(),
                                     finish_reason="error")]))
        return out

    def response(self):
        """Terminal non-streaming view: `ChatCompletionResponse` or
        `CompletionResponse`.  Raises `APIStatusError` if the stream closed
        with an error, RuntimeError if it has not closed yet."""
        if not self.closed:
            raise RuntimeError("stream not finished; advance the event loop "
                               "(e.g. PendingCompletion.result())")
        if self.error is not None:
            raise APIStatusError(self.error)
        usage = Usage.from_request(self.req)
        if self.kind == "chat":
            return ChatCompletionResponse(
                id=self.id, model=self.model, created=self.created,
                choices=[ChatChoice(index=0,
                                    message=ChatMessage(
                                        role="assistant",
                                        content=self.output_tokens),
                                    finish_reason=self.finish_reason)],
                usage=usage)
        return CompletionResponse(
            id=self.id, model=self.model, created=self.created,
            choices=[CompletionChoice(index=0, tokens=self.output_tokens,
                                      finish_reason=self.finish_reason)],
            usage=usage)
