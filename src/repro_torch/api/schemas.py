"""Typed OpenAI-compatible wire schemas for the serving API (paper §3.1.2).

The reproduction works at the token level (there is no tokenizer in the
repo), so message/prompt content is a list of token ids; plain strings are
accepted and encoded with a deterministic byte-level stand-in
(`encode_text`) so examples stay readable.  Every type round-trips through
``to_dict`` / ``from_dict`` — that pair *is* the wire contract, and
`tests/test_api.py` locks it with golden round-trip tests.

Validation is strict and field-addressed: any violation raises
`APIStatusError` carrying a structured 422 `APIError` whose ``param`` names
the offending field (the paper: "request properties are strongly typed and
validated").
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Optional, Union

from repro_torch.api.errors import APIStatusError, validation_error
from repro_torch.config import SLO_CLASSES
from repro_torch.engine.request import Request, SamplingParams

ROLES = ("system", "user", "assistant", "tool")


def encode_text(text: str) -> list:
    """Deterministic byte-level text → token-id stand-in (ids 1..256), used
    when message content is given as a string instead of token ids."""
    return [b + 1 for b in text.encode("utf-8")]


def _fail(param: str, message: str):
    raise APIStatusError(validation_error(param, message))


def _is_token_id(t) -> bool:
    """Any non-bool integer-like (Python int, numpy integer, ...) >= 0."""
    if isinstance(t, bool):
        return False
    try:
        return operator.index(t) >= 0
    except TypeError:
        return False


def _check_token_list(toks, param: str):
    if not isinstance(toks, list) or not all(_is_token_id(t) for t in toks):
        _fail(param, f"{param} must be a list of non-negative token ids")


@dataclass
class ChatMessage:
    role: str
    content: Union[list, str]   # token ids, or text (byte-level encoded)

    def token_ids(self) -> list:
        return encode_text(self.content) if isinstance(self.content, str) \
            else list(self.content)

    def validate(self, param: str = "messages"):
        if self.role not in ROLES:
            _fail(f"{param}.role",
                  f"role {self.role!r} must be one of {ROLES}")
        if isinstance(self.content, str):
            return
        _check_token_list(self.content, f"{param}.content")

    def to_dict(self) -> dict:
        return {"role": self.role, "content": self.content}

    @classmethod
    def from_dict(cls, d: dict) -> "ChatMessage":
        return cls(role=d["role"], content=d["content"])


@dataclass
class _RequestBase:
    """Fields, validation and serialisation shared by both request types:
    one definition so the two endpoints' wire contracts can never drift."""
    model: str
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 128
    n: int = 1                  # choices per request (fan-out, OpenAI `n`)
    stream: bool = False
    priority: int = 0
    # latency-target tier (config.SLO_CLASSES): weights the slo_cost
    # router's endpoint scoring and the gateway queue's ordering; the
    # benchmark harness reports SLO attainment against the class targets
    slo_class: str = "standard"
    session_id: Optional[str] = None
    # multi-agent workflow key: all stages of one agent pipeline carry the
    # same id so workflow-affinity routing can pin them to one instance
    # for cross-agent KV reuse (repro_torch.core.kvstore / docs/kv_store.md)
    workflow_id: Optional[str] = None
    seed: int = 0
    stop_token: Optional[int] = None
    # benchmark mode: stop exactly at this many output tokens (BurstGPT)
    target_output_len: Optional[int] = None

    def _sampling(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature, top_k=self.top_k,
                              top_p=self.top_p, max_new_tokens=self.max_tokens,
                              target_output_len=self.target_output_len,
                              seed=self.seed, stop_token=self.stop_token)

    def _validate_base(self):
        """Strict typing for the shared fields; value ranges delegate to
        SamplingParams.validate so the gateway and the wire layer can never
        disagree."""
        if not isinstance(self.model, str) or not self.model:
            _fail("model", "model must be a non-empty string")
        if type(self.stream) is not bool:
            _fail("stream", f"stream {self.stream!r} must be a bool")
        if type(self.priority) is not int:
            _fail("priority", f"priority {self.priority!r} must be an int")
        if self.slo_class not in SLO_CLASSES:
            _fail("slo_class", f"slo_class {self.slo_class!r} must be one "
                               f"of {SLO_CLASSES}")
        if self.session_id is not None \
                and not isinstance(self.session_id, str):
            _fail("session_id", "session_id must be a string or null")
        if self.workflow_id is not None \
                and not isinstance(self.workflow_id, str):
            _fail("workflow_id", "workflow_id must be a string or null")
        if type(self.max_tokens) is not int or self.max_tokens < 1:
            _fail("max_tokens",
                  f"max_tokens {self.max_tokens!r} must be an int >= 1")
        if type(self.n) is not int or not (1 <= self.n <= 16):
            _fail("n", f"n {self.n!r} must be an int in [1, 16]")
        if self.n > 1 and self.stream:
            _fail("n", "n > 1 is not supported with stream=true; "
                       "collect the choices from the non-streaming response")
        try:
            self._sampling().validate()
        except ValueError as e:
            _fail(getattr(e, "param", "sampling"), str(e))

    def _base_dict(self) -> dict:
        return {"model": self.model,
                "temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "max_tokens": self.max_tokens,
                "n": self.n,
                "stream": self.stream, "priority": self.priority,
                "slo_class": self.slo_class,
                "session_id": self.session_id,
                "workflow_id": self.workflow_id, "seed": self.seed,
                "stop_token": self.stop_token,
                "target_output_len": self.target_output_len}

    def _engine_request(self, prompt_tokens: list) -> Request:
        return Request(prompt_tokens=prompt_tokens, model=self.model,
                       session_id=self.session_id,
                       workflow_id=self.workflow_id, priority=self.priority,
                       slo_class=self.slo_class,
                       sampling=self._sampling())


@dataclass
class ChatCompletionRequest(_RequestBase):
    """POST /v1/chat/completions."""
    messages: list = field(default_factory=list)   # list[ChatMessage]

    def validate(self):
        self._validate_base()
        if not isinstance(self.messages, list) or not self.messages:
            _fail("messages", "messages must be a non-empty list")
        for i, m in enumerate(self.messages):
            if not isinstance(m, ChatMessage):
                _fail(f"messages[{i}]", "messages entries must be "
                                        "ChatMessage objects")
            m.validate(param=f"messages[{i}]")
        if not any(m.token_ids() for m in self.messages):
            _fail("messages", "messages must carry at least one token")

    def to_engine_request(self) -> Request:
        toks = []
        for m in self.messages:
            toks.extend(m.token_ids())
        return self._engine_request(toks)

    def to_dict(self) -> dict:
        d = self._base_dict()
        d["messages"] = [m.to_dict() for m in self.messages]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        d = dict(d)
        d["messages"] = [ChatMessage.from_dict(m)
                         for m in d.get("messages", [])]
        return cls(**d)


@dataclass
class CompletionRequest(_RequestBase):
    """POST /v1/completions (token-level prompt)."""
    prompt: Union[list, str] = field(default_factory=list)   # token ids

    def validate(self):
        self._validate_base()
        if not isinstance(self.prompt, str):
            _check_token_list(self.prompt, "prompt")
        if not self.prompt:
            _fail("prompt", "prompt must not be empty")

    def prompt_token_ids(self) -> list:
        return encode_text(self.prompt) if isinstance(self.prompt, str) \
            else list(self.prompt)

    def to_engine_request(self) -> Request:
        return self._engine_request(self.prompt_token_ids())

    @classmethod
    def from_engine(cls, req: Request, model: str,
                    stream: bool = False) -> "CompletionRequest":
        """Wire view of a pre-built engine request (workload generators in
        `repro_torch.data.burstgpt` produce engine Requests)."""
        sp = req.sampling
        return cls(model=model, prompt=list(req.prompt_tokens),
                   temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
                   max_tokens=sp.max_new_tokens, stream=stream,
                   priority=req.priority, slo_class=req.slo_class,
                   session_id=req.session_id, workflow_id=req.workflow_id,
                   seed=sp.seed, stop_token=sp.stop_token,
                   target_output_len=sp.target_output_len)

    def to_dict(self) -> dict:
        d = self._base_dict()
        d["prompt"] = self.prompt
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionRequest":
        return cls(**d)


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------

@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    @classmethod
    def from_request(cls, req: Request) -> "Usage":
        m = req.metrics
        if m.finish_time is not None:       # engine-recorded accounting
            return cls(prompt_tokens=m.prompt_tokens,
                       completion_tokens=m.completion_tokens)
        return cls(prompt_tokens=req.prompt_len,
                   completion_tokens=req.output_len)

    def to_dict(self) -> dict:
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.total_tokens}

    @classmethod
    def from_dict(cls, d: dict) -> "Usage":
        return cls(prompt_tokens=d["prompt_tokens"],
                   completion_tokens=d["completion_tokens"])


@dataclass
class ChatChoice:
    index: int
    message: ChatMessage
    finish_reason: Optional[str] = None    # "stop" | "length" | "error"

    def to_dict(self) -> dict:
        return {"index": self.index, "message": self.message.to_dict(),
                "finish_reason": self.finish_reason}

    @classmethod
    def from_dict(cls, d: dict) -> "ChatChoice":
        return cls(index=d["index"],
                   message=ChatMessage.from_dict(d["message"]),
                   finish_reason=d.get("finish_reason"))


@dataclass
class ChatCompletionResponse:
    id: str
    model: str
    created: float                          # virtual-clock submission time
    choices: list                           # list[ChatChoice]
    usage: Usage
    object: str = "chat.completion"

    def to_dict(self) -> dict:
        return {"id": self.id, "object": self.object, "model": self.model,
                "created": self.created,
                "choices": [c.to_dict() for c in self.choices],
                "usage": self.usage.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionResponse":
        return cls(id=d["id"], model=d["model"], created=d["created"],
                   choices=[ChatChoice.from_dict(c) for c in d["choices"]],
                   usage=Usage.from_dict(d["usage"]),
                   object=d.get("object", "chat.completion"))


@dataclass
class CompletionChoice:
    index: int
    tokens: list                            # generated token ids
    finish_reason: Optional[str] = None

    def to_dict(self) -> dict:
        return {"index": self.index, "tokens": list(self.tokens),
                "finish_reason": self.finish_reason}

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionChoice":
        return cls(index=d["index"], tokens=list(d["tokens"]),
                   finish_reason=d.get("finish_reason"))


@dataclass
class CompletionResponse:
    id: str
    model: str
    created: float
    choices: list                           # list[CompletionChoice]
    usage: Usage
    object: str = "text_completion"

    def to_dict(self) -> dict:
        return {"id": self.id, "object": self.object, "model": self.model,
                "created": self.created,
                "choices": [c.to_dict() for c in self.choices],
                "usage": self.usage.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionResponse":
        return cls(id=d["id"], model=d["model"], created=d["created"],
                   choices=[CompletionChoice.from_dict(c)
                            for c in d["choices"]],
                   usage=Usage.from_dict(d["usage"]),
                   object=d.get("object", "text_completion"))


# ---------------------------------------------------------------------------
# streaming chunks (SSE-analogue deltas)
# ---------------------------------------------------------------------------

@dataclass
class ChunkDelta:
    content: list = field(default_factory=list)   # token ids in this delta
    role: Optional[str] = None                    # "assistant" on 1st chunk

    def to_dict(self) -> dict:
        d = {"content": list(self.content)}
        if self.role is not None:
            d["role"] = self.role
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChunkDelta":
        return cls(content=list(d.get("content", [])), role=d.get("role"))


@dataclass
class ChunkChoice:
    index: int
    delta: ChunkDelta
    finish_reason: Optional[str] = None

    def to_dict(self) -> dict:
        return {"index": self.index, "delta": self.delta.to_dict(),
                "finish_reason": self.finish_reason}

    @classmethod
    def from_dict(cls, d: dict) -> "ChunkChoice":
        return cls(index=d["index"], delta=ChunkDelta.from_dict(d["delta"]),
                   finish_reason=d.get("finish_reason"))


@dataclass
class ChatCompletionChunk:
    id: str
    model: str
    created: float                 # client-observed token timestamp
    choices: list                  # list[ChunkChoice]
    usage: Optional[Usage] = None  # present on the final chunk only
    object: str = "chat.completion.chunk"

    def to_dict(self) -> dict:
        return {"id": self.id, "object": self.object, "model": self.model,
                "created": self.created,
                "choices": [c.to_dict() for c in self.choices],
                "usage": None if self.usage is None else self.usage.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionChunk":
        return cls(id=d["id"], model=d["model"], created=d["created"],
                   choices=[ChunkChoice.from_dict(c) for c in d["choices"]],
                   usage=None if d.get("usage") is None
                   else Usage.from_dict(d["usage"]),
                   object=d.get("object", "chat.completion.chunk"))
