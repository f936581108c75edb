"""OpenAI-style error taxonomy for the serving API (paper §3.1.2).

The paper's Web Gateway answers with *custom status codes* (401/422/429/
460/461/462 plus 200/202).  Bare ints leak engine internals to every client, so
this module defines the single exhaustive mapping from those codes to
structured OpenAI-shaped error objects — ``{"error": {"type", "code",
"message", "param", "retry_after"}}`` — that the `ServingClient` facade and
the wire schemas raise/serialise.  ``retry_after`` is derived by the
gateway from its queue TTL (queuing enabled) or the autoscaler's scale-up
cooldown (queuing disabled): the earliest time a retry could plausibly find
a ready endpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ErrorSpec:
    """One row of the status-code → wire-error mapping table."""
    http_status: int
    type: str
    code: str
    message: str
    retryable: bool = False


#: The exhaustive gateway-status → error taxonomy.  Statuses absent from
#: this table (200 OK, 202 QUEUED) are successes and map to no error.
ERROR_TABLE: dict[int, ErrorSpec] = {
    401: ErrorSpec(401, "authentication_error", "invalid_api_key",
                   "Incorrect API key provided."),
    422: ErrorSpec(422, "invalid_request_error", "invalid_value",
                   "Request validation failed."),
    429: ErrorSpec(429, "rate_limit_error", "tenant_quota_exceeded",
                   "The tenant's rate limit or concurrency cap was "
                   "exceeded.", retryable=True),
    460: ErrorSpec(460, "invalid_request_error", "model_not_found",
                   "The requested model does not exist or has no "
                   "configuration."),
    461: ErrorSpec(461, "service_unavailable_error", "model_not_ready",
                   "The model is configured but no endpoint is ready yet.",
                   retryable=True),
    462: ErrorSpec(462, "service_unavailable_error", "instance_unreachable",
                   "A registered endpoint exists but the backing instance "
                   "is gone.", retryable=True),
}

#: Non-error statuses, kept next to the table so the golden test can assert
#: the union covers every code the gateway can return.
SUCCESS_STATUSES: dict[int, str] = {200: "ok", 202: "queued"}


@dataclass
class APIError:
    """A structured wire error (the value of the ``"error"`` key)."""
    http_status: int
    type: str
    code: str
    message: str
    param: Optional[str] = None          # offending field for 422s
    retry_after: Optional[float] = None  # seconds; retryable statuses only

    def to_dict(self) -> dict:
        body = {"type": self.type, "code": self.code,
                "message": self.message, "param": self.param,
                "http_status": self.http_status}
        if self.retry_after is not None:
            body["retry_after"] = self.retry_after
        return {"error": body}

    @classmethod
    def from_dict(cls, d: dict) -> "APIError":
        body = d["error"]
        return cls(http_status=body["http_status"], type=body["type"],
                   code=body["code"], message=body["message"],
                   param=body.get("param"),
                   retry_after=body.get("retry_after"))


class APIStatusError(Exception):
    """Raised by `ServingClient` for any non-success gateway answer."""

    def __init__(self, error: APIError):
        self.error = error
        self.status = error.http_status
        super().__init__(f"[{error.http_status}] {error.type}/{error.code}: "
                         f"{error.message}"
                         + (f" (param={error.param})" if error.param else ""))


def error_for_status(status: int, *, param: Optional[str] = None,
                     message: Optional[str] = None,
                     retry_after: Optional[float] = None) -> Optional[APIError]:
    """Map a gateway status code to a structured error (None for 200/202).

    Raises KeyError for a status outside the taxonomy — the gateway cannot
    emit one, and a silent fallback would hide a contract break.
    """
    if status in SUCCESS_STATUSES:
        return None
    spec = ERROR_TABLE[status]
    return APIError(http_status=spec.http_status, type=spec.type,
                    code=spec.code, message=message or spec.message,
                    param=param,
                    retry_after=retry_after if spec.retryable else None)


def validation_error(param: Optional[str], message: str) -> APIError:
    """Convenience: a 422 with the offending field name attached."""
    return error_for_status(422, param=param, message=message)


# -- shared field-addressed validation helpers (spec/schema modules) --------

def raise_validation(param: str, message: str):
    """Raise the structured 422 for one offending field."""
    raise APIStatusError(validation_error(param, message))


def check_int(v, param: str, minimum: Optional[int] = None):
    """Strict int (bools excluded by `type is int`) with optional floor."""
    if type(v) is not int:
        raise_validation(param, f"{param} {v!r} must be an int")
    if minimum is not None and v < minimum:
        raise_validation(param, f"{param} {v!r} must be >= {minimum}")


def check_number(v, param: str, minimum: float = 0.0):
    if not isinstance(v, (int, float)) or isinstance(v, bool) or v < minimum:
        raise_validation(param, f"{param} {v!r} must be a number >= {minimum}")
