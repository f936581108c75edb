"""Disaggregated prefill/decode serving (beyond-paper subsystem).

The paper's architecture routes every request to one vLLM replica for its
whole lifetime, so a 2k-token prefill chunk rides in the same mixed step as
every decoding sequence on that replica: decodes see prefill-chunk-sized
TBT, and new prompts wait on decode-held slots.  The vLLM production-stack
proposals (`disaggregated-prefill-orchestrated-routing`,
`pd-disagg-crd-support`; see PAPERS.md) split the fleet into
phase-specialised pools behind an orchestrated two-hop router; this module
is that subsystem for the repro stack:

* **Engine layer** (repro_torch.engine) — `LLMEngine`/`Scheduler` carry a
  ``phase_mode`` (``unified`` / ``prefill_only`` / ``decode_only``).  A
  prefill-only engine runs a request to its first token (the client's TTFT
  comes from the prefill pool) then exports its sealed prompt blocks as a
  serialisable `KVHandoff` (content chain-hashes from
  `BlockAllocator`/`SequenceKV`); a decode-only engine imports the handoff
  (`import_handoff` re-seals the blocks so admission's ``match_prefix``
  reattaches them) and continues generation.
* **Control plane** (repro_torch.core.deployments) — `ModelDeploymentSpec`
  gains a `DisaggregationSpec` block (defined here): prefill vs decode replica
  windows plus the KV transfer-bandwidth knob.  One deployment reconciles
  two phase pools; jobs and endpoints are tagged with their pool's
  ``phase`` and drain/rolling-update semantics apply per pool.
* **Gateway** (repro_torch.core.web_gateway) — the `DisaggregatedRouter`
  policy dispatches the prefill hop to the prefill pool; on handoff the gateway
  charges the KV transfer cost (``handoff.kv_bytes`` from the roofline
  cost model over `DisaggProfile.transfer_bandwidth`) and re-enqueues the
  decode hop, dispatch-epoch guarded, falling back to unified instances
  when a pool is empty.  A decode instance dying mid-stream triggers a
  transparent re-run of the prefill hop (budgeted by
  `DisaggProfile.max_retries`), with the gateway queue + reconciler
  covering the window where no replacement is up yet.
* **Autoscaler** (repro_torch.core.metrics_gateway / autoscaler) — per-phase
  queue depths are scraped per deployment and pool-addressed alert rules
  grow the prefill and decode pools independently.

`benchmarks/disagg.py` compares unified vs disaggregated serving on a
mixed long-prompt/chat BurstGPT workload at the paper's concurrencies.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# the KV handoff wire objects live next to the allocator they describe;
# re-exported here so the subsystem has one import surface
from repro_torch.api.errors import check_int as _check_int
from repro_torch.api.errors import raise_validation as _fail
from repro_torch.engine.kv_cache import (  # noqa: F401
    KVHandoff, export_handoff, import_handoff)
from repro_torch.engine.request import Request
from repro_torch.core.router import POLICIES, RoutingPolicy, make_policy

#: pool phases (endpoint/job row tag; None = unified, the paper default)
PHASES = ("prefill", "decode")


# ---------------------------------------------------------------------------
# spec block (ModelDeploymentSpec.disaggregation)
# ---------------------------------------------------------------------------

@dataclass
class DisaggregationSpec:
    """Desired shape of one deployment's two phase pools.

    Each pool has its own replica window so the autoscaler can grow
    prefill and decode capacity independently (`Reconciler.patch_replicas`
    with ``pool=...``).  ``transfer_bandwidth`` is the prefill->decode KV
    link (bytes/s) the gateway charges `KVHandoff.kv_bytes` against —
    NVLink/ICI-class by default."""
    prefill_replicas: int = 1
    decode_replicas: int = 1
    min_prefill_replicas: int = 1
    max_prefill_replicas: int = 8
    min_decode_replicas: int = 1
    max_decode_replicas: int = 8
    transfer_bandwidth: float = 40e9
    # transparent prefill-hop re-runs after an instance dies mid-stream
    max_retries: int = 2
    # chunked handoff streaming (repro_torch.core.kvstore.LinkContentionModel):
    # the payload moves in this many chunks and the decode hop dispatches
    # after the FIRST one lands; 1 reproduces PR 4's atomic handoff
    stream_chunks: int = 8

    def validate(self, param: str = "disaggregation"):
        for pool in PHASES:
            lo = getattr(self, f"min_{pool}_replicas")
            hi = getattr(self, f"max_{pool}_replicas")
            n = getattr(self, f"{pool}_replicas")
            _check_int(lo, f"{param}.min_{pool}_replicas", minimum=0)
            _check_int(hi, f"{param}.max_{pool}_replicas", minimum=1)
            if hi < lo:
                _fail(f"{param}.max_{pool}_replicas",
                      f"max_{pool}_replicas {hi} must be >= "
                      f"min_{pool}_replicas {lo}")
            _check_int(n, f"{param}.{pool}_replicas", minimum=0)
            if not (lo <= n <= hi):
                _fail(f"{param}.{pool}_replicas",
                      f"{pool}_replicas {n} must lie in [{lo}, {hi}]")
        if not isinstance(self.transfer_bandwidth, (int, float)) \
                or isinstance(self.transfer_bandwidth, bool) \
                or self.transfer_bandwidth <= 0:
            _fail(f"{param}.transfer_bandwidth",
                  f"transfer_bandwidth {self.transfer_bandwidth!r} must be "
                  f"a number > 0 (bytes/s)")
        _check_int(self.max_retries, f"{param}.max_retries", minimum=0)
        _check_int(self.stream_chunks, f"{param}.stream_chunks", minimum=1)

    def window(self, pool: str) -> tuple:
        return (getattr(self, f"min_{pool}_replicas"),
                getattr(self, f"max_{pool}_replicas"))

    def desired(self, pool: str) -> int:
        lo, hi = self.window(pool)
        return max(lo, min(hi, getattr(self, f"{pool}_replicas")))

    def to_dict(self) -> dict:
        return {"prefill_replicas": self.prefill_replicas,
                "decode_replicas": self.decode_replicas,
                "min_prefill_replicas": self.min_prefill_replicas,
                "max_prefill_replicas": self.max_prefill_replicas,
                "min_decode_replicas": self.min_decode_replicas,
                "max_decode_replicas": self.max_decode_replicas,
                "transfer_bandwidth": self.transfer_bandwidth,
                "max_retries": self.max_retries,
                "stream_chunks": self.stream_chunks}

    @classmethod
    def from_dict(cls, d: dict) -> "DisaggregationSpec":
        import dataclasses
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            _fail(f"disaggregation.{unknown[0]}",
                  f"unknown field(s) {unknown} in DisaggregationSpec")
        return cls(**d)


@dataclass
class DisaggProfile:
    """Gateway-side per-model disaggregation knobs (derived from the
    deployment's `DisaggregationSpec`, or installed directly)."""
    transfer_bandwidth: float = 40e9
    max_retries: int = 2
    stream_chunks: int = 8

    def transfer_time(self, handoff: KVHandoff) -> float:
        """Uncontended whole-payload duration (the chunked path charges
        per chunk through the shared link and sums to this when idle)."""
        return handoff.kv_bytes / self.transfer_bandwidth


# ---------------------------------------------------------------------------
# phase-aware routing policy
# ---------------------------------------------------------------------------

def request_phase(req: Request) -> str:
    """Which pool a request's NEXT hop belongs to: a request carrying a
    handoff (or already-streamed tokens) is on its decode hop."""
    return "decode" if (req.handoff is not None or req.output_tokens) \
        else "prefill"


class DisaggregatedRouter(RoutingPolicy):
    """Two-pool orchestrated routing (production-stack
    `disaggregated-prefill-orchestrated-routing`): filter the ready
    endpoints down to the hop's phase pool, then delegate endpoint choice
    within the pool to an inner policy (least-loaded by default).  An empty
    pool falls back to unified instances — a unified engine simply serves
    the request end-to-end (prefill hop) or imports the handoff and decodes
    (decode hop) — and, as a last resort, to whatever is alive."""

    name = "disaggregated"
    wants_load_fn = True
    wants_prior_fn = True

    def __init__(self, load_fn=None, prior_fn=None,
                 inner: str = "least_loaded"):
        super().__init__()
        if inner == self.name:       # no self-nesting
            inner = "least_loaded"
        self.inner_name = inner
        self._inner = make_policy(inner, load_fn=load_fn,
                                  prior_fn=prior_fn)
        self.hops = {"prefill": 0, "decode": 0}
        self.pool_fallbacks = 0

    def select(self, eps: list, req: Request) -> dict:
        wanted = request_phase(req)
        self.hops[wanted] += 1
        pool = [e for e in eps if e.get("phase") == wanted]
        if not pool:
            self.pool_fallbacks += 1
            pool = [e for e in eps
                    if e.get("phase") in (None, "unified")] or eps
        return self._inner.select(pool, req)

    def note_dispatch(self, ep: dict, req: Request):
        super().note_dispatch(ep, req)
        self._inner.note_dispatch(ep, req)

    def note_finish(self, ep_key: tuple, req: Request):
        self._inner.note_finish(ep_key, req)

    def stats(self) -> dict:
        out = super().stats()
        out.update(inner=self.inner_name, hops=dict(self.hops),
                   pool_fallbacks=self.pool_fallbacks)
        return out


POLICIES["disaggregated"] = DisaggregatedRouter
