"""Wire views for the multi-tenant QoS surface (docs/tenancy.md).

The QoS machinery itself lives in `repro_torch.core.tenancy` (`TenantSpec`,
`TokenBucket`, `TenancyManager` — core imports api, never the reverse);
this module holds the client-facing wire objects: the aggregated
`TenantUsage` block returned by `AdminClient.tenant_usage` and built from
the DB-backed `tenant_usage_records` rows.  Like every schema in
`repro_torch.api`, ``to_dict``/``from_dict`` round-trip and *are* the wire
contract.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TenantUsage:
    """Aggregated metering for one tenant: what the usage records sum to
    over a reporting window (all-time when unfiltered).  ``queue_wait``
    and ``kv_transfer_time`` are seconds summed across requests; token
    counts come from the engines' `RequestMetrics` at finish, so billing
    and the Table-1 throughput numbers can never disagree."""
    tenant: str
    requests: int = 0
    failed: int = 0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    queue_wait: float = 0.0
    kv_transfer_time: float = 0.0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    @classmethod
    def from_records(cls, tenant: str, records: list) -> "TenantUsage":
        """Fold windowed `tenant_usage_records` rows (wire dicts) into one
        aggregate."""
        u = cls(tenant=tenant)
        for r in records:
            u.requests += r["requests"]
            u.failed += r["failed"]
            u.prompt_tokens += r["prompt_tokens"]
            u.completion_tokens += r["completion_tokens"]
            u.queue_wait += r["queue_wait"]
            u.kv_transfer_time += r["kv_transfer_time"]
        return u

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "requests": self.requests,
                "failed": self.failed,
                "prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.total_tokens,
                "queue_wait": self.queue_wait,
                "kv_transfer_time": self.kv_transfer_time}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantUsage":
        return cls(tenant=d["tenant"], requests=d["requests"],
                   failed=d["failed"], prompt_tokens=d["prompt_tokens"],
                   completion_tokens=d["completion_tokens"],
                   queue_wait=d["queue_wait"],
                   kv_transfer_time=d["kv_transfer_time"])
