"""Central relational store — the paper's Fig. 2 schema, verbatim.

Two domains: (a) authentication, (b) Slurm job management. PostgreSQL is not
the contribution, so this is an in-process transactional table store with
the same tables, keys and 1:N relations (enforced), plus the encrypted
API-key storage semantics (we store salted hashes; plaintext never rests).
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional


class Table:
    def __init__(self, name: str, columns: tuple, fks: dict | None = None):
        self.name = name
        self.columns = columns
        self.rows: dict[int, dict] = {}
        self._ids = itertools.count(1)
        self.fks = fks or {}          # column -> (table, on_delete)

    def insert(self, db: "Database", **values) -> dict:
        unknown = set(values) - set(self.columns)
        if unknown:
            raise ValueError(f"{self.name}: unknown columns {unknown}")
        for col, (ref, _) in self.fks.items():
            v = values.get(col)
            if v is not None and v not in db[ref].rows:
                raise ValueError(f"{self.name}.{col}: FK violation -> {ref}#{v}")
        row = {c: values.get(c) for c in self.columns}
        row["id"] = next(self._ids)
        self.rows[row["id"]] = row
        return row

    def get(self, rid: int) -> Optional[dict]:
        return self.rows.get(rid)

    def select(self, **where) -> list[dict]:
        out = []
        for row in self.rows.values():
            if all(row.get(k) == v for k, v in where.items()):
                out.append(row)
        return out

    def update(self, rid: int, **values) -> dict:
        row = self.rows[rid]
        row.update(values)
        return row

    def delete(self, db: "Database", rid: int):
        if rid not in self.rows:
            return
        # cascade to children referencing this row
        for t in db.tables.values():
            for col, (ref, on_delete) in t.fks.items():
                if ref != self.name:
                    continue
                for child in list(t.rows.values()):
                    if child.get(col) == rid:
                        if on_delete == "cascade":
                            t.delete(db, child["id"])
                        else:
                            child[col] = None
        del self.rows[rid]


def _hash_key(api_key: str) -> str:
    return hashlib.sha256(("repro-salt:" + api_key).encode()).hexdigest()


class Database:
    """The single central PostgreSQL of the paper, schema per Fig. 2."""

    def __init__(self):
        self.tables = {}
        for t in [
            Table("identity_tenants", ("id", "name")),
            Table("identity_tenant_authentications",
                  ("id", "tenant_id", "api_key_hash"),
                  fks={"tenant_id": ("identity_tenants", "cascade")}),
            # QoS policy per tenant (repro_torch.core.tenancy.TenantSpec):
            # fair-share weight, token-bucket limits, concurrency cap. 1:1
            # with identity_tenants; absence = unlimited / weight-1.0
            # default.
            Table("identity_tenant_policies",
                  ("id", "tenant_id", "weight", "requests_per_sec",
                   "tokens_per_min", "burst_requests", "burst_tokens",
                   "max_inflight", "priority_class"),
                  fks={"tenant_id": ("identity_tenants", "cascade")}),
            # windowed usage metering (60 s windows): what the Metrics
            # Gateway scrapes as per-tenant series and billing reads
            Table("tenant_usage_records",
                  ("id", "tenant_id", "model_name", "window_start",
                   "requests", "failed", "prompt_tokens",
                   "completion_tokens", "queue_wait", "kv_transfer_time"),
                  fks={"tenant_id": ("identity_tenants", "cascade")}),
            Table("ai_model_configurations",
                  ("id", "model_name", "model_version", "instances",
                   "gpus_per_node", "nodes", "est_load_time",
                   "max_model_len", "slurm_partition")),
            Table("ai_model_endpoint_jobs",
                  ("id", "configuration_id", "slurm_job_id", "submitted_at",
                   "registered_at", "ready_at", "phase"),
                  fks={"configuration_id": ("ai_model_configurations",
                                            "cascade")}),
            Table("ai_model_endpoints",
                  ("id", "endpoint_job_id", "node", "port", "model_name",
                   "model_version", "bearer_token", "ready_at", "phase"),
                  fks={"endpoint_job_id": ("ai_model_endpoint_jobs",
                                           "cascade")}),
        ]:
            self.tables[t.name] = t

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    # -- authentication domain -------------------------------------------
    def create_tenant(self, name: str, api_key: str) -> dict:
        t = self["identity_tenants"].insert(self, name=name)
        self["identity_tenant_authentications"].insert(
            self, tenant_id=t["id"], api_key_hash=_hash_key(api_key))
        return t

    def authenticate(self, api_key: str) -> Optional[dict]:
        h = _hash_key(api_key)
        rows = self["identity_tenant_authentications"].select(api_key_hash=h)
        if not rows:
            return None
        return self["identity_tenants"].get(rows[0]["tenant_id"])

    # -- consistency invariants (exercised by tests) ----------------------
    def check_invariants(self):
        for ep in self["ai_model_endpoints"].rows.values():
            job = self["ai_model_endpoint_jobs"].get(ep["endpoint_job_id"])
            assert job is not None, "endpoint without job"
        for job in self["ai_model_endpoint_jobs"].rows.values():
            cfgr = self["ai_model_configurations"].get(job["configuration_id"])
            assert cfgr is not None, "job without configuration"
        # port uniqueness per node (the Endpoint Gateway's contract)
        seen = set()
        for ep in self["ai_model_endpoints"].rows.values():
            key = (ep["node"], ep["port"])
            assert key not in seen, f"duplicate port on node: {key}"
            seen.add(key)
