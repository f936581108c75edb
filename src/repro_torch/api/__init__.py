"""OpenAI-compatible serving API layer (paper §3.1.2) plus the
declarative admin surface.

Typed wire schemas, the status-code → structured-error taxonomy, SSE-
analogue `TokenStream` sessions, the `ServingClient` facade, and the
kubectl-shaped `AdminClient` over ModelDeployment specs (see
docs/control_plane.md).  This package is the stable surface clients
program against; `repro_torch.core` (the gateway, the reconciler) imports it,
never the other way around.
"""
from repro_torch.api.admin import AdminClient, DeploymentWatch, WatchEvent
from repro_torch.api.alerts import AlertWatch
from repro_torch.api.client import (MultiPendingCompletion, PendingCompletion,
                              ServingClient)
from repro_torch.api.errors import (APIError, APIStatusError, ERROR_TABLE,
                              ErrorSpec, SUCCESS_STATUSES, error_for_status,
                              validation_error)
from repro_torch.api.schemas import (ChatChoice, ChatCompletionChunk,
                               ChatCompletionRequest, ChatCompletionResponse,
                               ChatMessage, ChunkChoice, ChunkDelta,
                               CompletionChoice, CompletionRequest,
                               CompletionResponse, Usage, encode_text)
from repro_torch.api.streaming import StreamSession, TokenEvent, TokenStream
from repro_torch.api.tenancy import TenantUsage
from repro_torch.api.traces import (TraceWatch, critical_path_to_dict,
                              span_to_dict, trace_summary, trace_to_dict)

__all__ = [
    "APIError", "APIStatusError", "AdminClient", "AlertWatch", "ChatChoice",
    "ChatCompletionChunk", "ChatCompletionRequest", "ChatCompletionResponse",
    "ChatMessage", "ChunkChoice", "ChunkDelta", "CompletionChoice",
    "CompletionRequest", "CompletionResponse", "DeploymentWatch",
    "ERROR_TABLE", "ErrorSpec", "MultiPendingCompletion",
    "PendingCompletion", "ServingClient",
    "StreamSession", "SUCCESS_STATUSES", "TenantUsage", "TokenEvent",
    "TokenStream", "TraceWatch", "Usage", "WatchEvent",
    "critical_path_to_dict", "encode_text", "error_for_status",
    "span_to_dict", "trace_summary", "trace_to_dict", "validation_error",
]
