"""Hierarchical KV store: HBM -> host DRAM -> cluster-wide shared store.

The paper's deployment serves many users from a few shared services, so
recurring prompt prefixes dominate (Chat AI observes the same system
prompts and running conversations hitting the same replicas all day).
PR 7's `BlockAllocator` still *discards* evicted prompt KV: once the warm
evictable pool is recycled the prefix must be re-prefilled from scratch.
This module adds an LMCache-style tier hierarchy underneath the allocator:

* **HBM** (tier 0) — the `BlockAllocator` itself: resident blocks, ref
  counted, content-addressed by chain hash.  Unchanged semantics.
* **Host DRAM** (tier 1) — `TierCache` per engine.  When the allocator
  recycles an evictable block it *demotes* the block's chain hash here
  instead of forgetting it.  `lookup` misses consult this tier and
  re-materialise the block into HBM (promotion) — from the free list
  when possible, else by swapping out one warm evictable block (whose
  hash is demoted in turn, so nothing is ever lost).
* **Shared store** (tier 2) — a cluster-wide `TierCache` (one per model
  deployment) that demotions write through to.  A *different* engine of
  the same deployment can promote from it, which is what makes
  workflow-affinity routing pay off even across instance restarts.

Tiers hold chain hashes only: the simulator's KV blocks are content
addressed (`BlockAllocator.prefix_index`), so "holding the bytes" and
"being able to re-seal the block under its hash" are the same thing —
exactly the trick `KVHandoff` already uses for disaggregated transfers.

The module also provides the `LinkContentionModel`: a FIFO shared-NIC
bandwidth model replacing PR 4's atomic handoff charge.  Each chunk
reserves the link for ``chunk_bytes / bandwidth`` seconds starting when
the link frees, so simultaneous handoffs queue on bandwidth honestly
instead of each assuming the full ``transfer_bandwidth``.  Chunked
senders only reserve their next chunk after the previous one lands,
which interleaves concurrent handoffs at chunk granularity (see
`repro_torch.core.web_gateway.WebGateway.on_prefill_handoff`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.api.errors import check_int as _check_int
from repro_torch.api.errors import raise_validation as _fail

#: tier names, top (fastest) to bottom — used for stats keys and docs
TIERS = ("hbm", "host", "shared")


# ---------------------------------------------------------------------------
# spec block (ModelDeploymentSpec.kv_store)
# ---------------------------------------------------------------------------

@dataclass
class KVStoreSpec:
    """Tier sizing for one deployment's KV hierarchy.

    ``host_blocks`` is the per-engine host-DRAM tier capacity (in KV
    blocks); ``shared_blocks`` sizes the deployment's cluster-wide shared
    store.  Either may be 0 to disable that tier; a deployment without a
    ``kv_store`` block keeps the pre-tiering behaviour (evicted KV is
    discarded)."""
    host_blocks: int = 4096
    shared_blocks: int = 32768

    def validate(self, param: str = "kv_store"):
        _check_int(self.host_blocks, f"{param}.host_blocks", minimum=0)
        _check_int(self.shared_blocks, f"{param}.shared_blocks", minimum=0)

    def to_dict(self) -> dict:
        return {"host_blocks": self.host_blocks,
                "shared_blocks": self.shared_blocks}

    @classmethod
    def from_dict(cls, d: dict) -> "KVStoreSpec":
        import dataclasses
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            _fail(f"kv_store.{unknown[0]}",
                  f"unknown field(s) {unknown} in KVStoreSpec")
        return cls(**d)


# ---------------------------------------------------------------------------
# tier caches
# ---------------------------------------------------------------------------

class TierCache:
    """One lower tier: an LRU set of block chain hashes.

    Insertion order doubles as recency (dict ordering), so eviction pops
    the least-recently touched hash — deterministic, no clocks.  Keys are
    the allocator's chain hashes, so two entries collide iff the full
    token prefix they content-address is identical."""

    def __init__(self, capacity: int, name: str = "host"):
        self.capacity = int(capacity)
        self.name = name
        self._entries: dict[int, None] = {}
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, token_hash: int) -> bool:
        return token_hash in self._entries

    def put(self, token_hash: int) -> bool:
        """Insert (or refresh) a hash; evicts LRU entries over capacity."""
        if self.capacity <= 0:
            return False
        if token_hash in self._entries:
            self._entries.pop(token_hash)
            self._entries[token_hash] = None      # refresh recency
            return True
        self._entries[token_hash] = None
        self.insertions += 1
        while len(self._entries) > self.capacity:
            oldest = next(iter(self._entries))
            self._entries.pop(oldest)
            self.evictions += 1
        return True

    def get(self, token_hash: int) -> bool:
        """Hit test that counts and refreshes recency."""
        if token_hash in self._entries:
            self._entries.pop(token_hash)
            self._entries[token_hash] = None
            self.hits += 1
            return True
        self.misses += 1
        return False

    def stats(self) -> dict:
        return {"name": self.name, "size": len(self._entries),
                "capacity": self.capacity, "hits": self.hits,
                "misses": self.misses, "insertions": self.insertions,
                "evictions": self.evictions}


class TieredKVStore:
    """The allocator-facing facade over the lower tiers.

    Installed as ``BlockAllocator.tier_store``; the allocator calls
    `demote` when it recycles an evictable block and `lookup` when the
    HBM prefix index misses.  Demotions write through to the shared
    store (when present) so sibling engines can promote the same prefix
    without waiting for the host tier to spill."""

    def __init__(self, host: TierCache,
                 shared: Optional[TierCache] = None):
        self.host = host
        self.shared = shared
        self.demotions = 0
        self.promotions = 0

    def demote(self, token_hash: int):
        """HBM eviction -> host tier (write-through to the shared store)."""
        self.demotions += 1
        self.host.put(token_hash)
        if self.shared is not None:
            self.shared.put(token_hash)

    def lookup(self, token_hash: int) -> bool:
        """Consult host then shared; a shared hit is pulled up into the
        host tier on the way back (inclusive hierarchy)."""
        if self.host.get(token_hash):
            return True
        if self.shared is not None and self.shared.get(token_hash):
            self.host.put(token_hash)
            return True
        return False

    @property
    def host_hits(self) -> int:
        return self.host.hits

    @property
    def shared_hits(self) -> int:
        return self.shared.hits if self.shared is not None else 0

    def stats(self) -> dict:
        out = {"demotions": self.demotions, "promotions": self.promotions,
               "host": self.host.stats()}
        if self.shared is not None:
            out["shared"] = self.shared.stats()
        return out


def make_tier_store(spec: Optional[KVStoreSpec],
                    shared: Optional[TierCache] = None
                    ) -> Optional[TieredKVStore]:
    """Build one engine's tier store from a deployment spec.  ``shared``
    is the deployment-wide shared store (the caller keeps one per model
    and passes the same object to every engine).  Returns None when the
    spec disables tiering entirely."""
    if spec is None or (spec.host_blocks <= 0 and shared is None):
        return None
    return TieredKVStore(TierCache(spec.host_blocks, name="host"),
                         shared=shared)


# ---------------------------------------------------------------------------
# shared-NIC link model (chunked handoff streaming)
# ---------------------------------------------------------------------------

class LinkContentionModel:
    """FIFO bandwidth reservation for one shared KV link.

    ``transmit(nbytes, now)`` reserves the link from the instant it next
    frees: the transfer starts at ``max(now, busy_until)`` and holds the
    link for ``nbytes / bandwidth`` seconds, so N simultaneous transfers
    see the link serially — transfer k completes at
    ``t0 + (sum of sizes 1..k) / bandwidth`` — instead of all assuming
    the full bandwidth in parallel (PR 4's atomic model).  Senders that
    reserve chunk-by-chunk (next chunk only after the previous lands)
    interleave fairly at chunk granularity.

    Zero-byte transfers complete immediately without touching the queue
    (deployments without a roofline cost model have ``kv_bytes == 0``)."""

    def __init__(self, bandwidth: float):
        self.bandwidth = float(bandwidth)
        self.busy_until = 0.0
        self.transfers = 0
        self.bytes_sent = 0.0
        self.queue_delay_total = 0.0

    def transmit(self, nbytes: float, now: float) -> float:
        """Reserve the link for one chunk; returns its completion time."""
        size = max(0.0, float(nbytes))
        if size <= 0.0 or self.bandwidth <= 0.0:
            return now
        start = max(now, self.busy_until)
        self.queue_delay_total += start - now
        self.busy_until = start + size / self.bandwidth
        self.transfers += 1
        self.bytes_sent += size
        return self.busy_until

    def stats(self) -> dict:
        return {"bandwidth": self.bandwidth, "transfers": self.transfers,
                "bytes_sent": self.bytes_sent,
                "queue_delay_total": self.queue_delay_total}


def chunk_plan(kv_bytes: float, n_chunks: int) -> list:
    """Split a handoff payload into equal-size chunks (layer-granular in
    a real system; the simulator only needs the byte sizes).  Always
    returns at least one chunk so a zero-byte handoff still produces the
    first-chunk dispatch event."""
    n = max(1, int(n_chunks))
    total = max(0.0, float(kv_bytes))
    return [total / n] * n
