"""PagedAttention KV-cache manager (the vLLM core, §3.1.1 of the paper).

The KV cache is split into fixed-size blocks assigned to logical pages via
per-sequence block tables; a central manager owns the free list with
reference counting so blocks can be shared across sequences (prefix
caching). This file is the *control plane* (pure Python, O(blocks) ints);
the device-side pool lives in the executor and is indexed by the tables
produced here.

TPU adaptation: block_size defaults to 32 so a (block_size, head_dim) tile
is (8,128)-aligned for VMEM, instead of vLLM's GPU-warp-derived 16.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class OutOfBlocks(Exception):
    pass


@dataclass
class Block:
    idx: int
    ref_count: int = 0
    # filled token ids for prefix-hash reuse (content-addressed)
    token_hash: Optional[int] = None


class BlockAllocator:
    """Free-list allocator with ref counting + content-hash prefix reuse."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks = [Block(i) for i in range(num_blocks)]
        self.free_list = list(range(num_blocks - 1, -1, -1))
        self.enable_prefix_caching = enable_prefix_caching
        # token_hash -> block idx, for COMPLETE blocks only
        self.prefix_index: dict[int, int] = {}
        # blocks with ref_count 0 kept around for reuse (LRU-ish by order)
        self._evictable: dict[int, None] = {}
        # prefix-cache effectiveness counters (block-granular): every
        # `lookup` is one query, every non-None return one hit.  Scraped
        # through the engine snapshot so KV-aware routing (slo_cost) can
        # score endpoints by REAL per-endpoint hit rates instead of
        # pinning by hash blindly.
        self.prefix_queries = 0
        self.prefix_hits = 0
        # optional lower tiers (repro.core.kvstore.TieredKVStore): when
        # set, recycling an evictable block DEMOTES its chain hash down a
        # tier instead of discarding it, and lookup misses consult the
        # tiers and PROMOTE on hit.  None keeps discard-eviction.
        self.tier_store = None

    # -- invariant helpers (exercised by hypothesis tests) ---------------
    def num_free(self) -> int:
        return len(self.free_list) + len(self._evictable)

    def check_invariants(self):
        held = sum(1 for b in self.blocks if b.ref_count > 0)
        assert held + self.num_free() == self.num_blocks, \
            f"leak: held={held} free={self.num_free()} total={self.num_blocks}"
        for i in self.free_list:
            assert self.blocks[i].ref_count == 0

    # -- allocation -------------------------------------------------------
    def _recycle_evictable(self) -> int:
        """Pop one warm (ref-0, sealed) block from the evictable pool and
        strip its identity.  With tiers attached the evicted chain hash is
        DEMOTED down the hierarchy instead of forgotten — the block's
        content stays promotable."""
        idx, _ = self._evictable.popitem()
        old = self.blocks[idx]
        if old.token_hash is not None:
            if self.tier_store is not None:
                self.tier_store.demote(old.token_hash)
            self.prefix_index.pop(old.token_hash, None)
            old.token_hash = None
        return idx

    def allocate(self) -> int:
        if self.free_list:
            idx = self.free_list.pop()
        elif self._evictable:
            idx = self._recycle_evictable()
        else:
            raise OutOfBlocks()
        b = self.blocks[idx]
        assert b.ref_count == 0
        b.ref_count = 1
        return idx

    def fork(self, idx: int):
        """Share an existing block (prefix reuse)."""
        b = self.blocks[idx]
        if b.ref_count == 0:  # resurrect from evictable pool
            self._evictable.pop(idx, None)
        b.ref_count += 1

    def free(self, idx: int):
        b = self.blocks[idx]
        assert b.ref_count > 0, f"double free of block {idx}"
        b.ref_count -= 1
        if b.ref_count == 0:
            if b.token_hash is not None and self.enable_prefix_caching:
                self._evictable[idx] = None  # keep warm for prefix hits
            else:
                b.token_hash = None
                self.free_list.append(idx)

    def seal(self, idx: int, token_hash: int):
        """Mark a block complete & content-addressed for future reuse."""
        if not self.enable_prefix_caching:
            return
        self.blocks[idx].token_hash = token_hash
        self.prefix_index[token_hash] = idx

    def lookup(self, token_hash: int) -> Optional[int]:
        if not self.enable_prefix_caching:
            return None
        self.prefix_queries += 1
        idx = self.prefix_index.get(token_hash)
        if idx is not None and self.blocks[idx].token_hash == token_hash:
            self.prefix_hits += 1
            return idx
        # HBM miss: consult the lower tiers before giving up (re-prefill)
        idx = self._promote(token_hash)
        if idx is None:
            return None
        self.prefix_hits += 1
        return idx

    def _promote(self, token_hash: int) -> Optional[int]:
        """Re-materialise a demoted block from the host/shared tiers.
        Prefers truly free HBM blocks; with none left it SWAPS — recycling
        one warm evictable block (whose hash is demoted, so nothing is
        lost) for the block being requested right now.  A block some
        sequence still references is never touched, and with the pools
        empty on both sides the promotion is refused (the prefix is
        simply re-prefilled)."""
        if self.tier_store is None \
                or not (self.free_list or self._evictable):
            return None
        if not self.tier_store.lookup(token_hash):
            return None
        idx = self.free_list.pop() if self.free_list \
            else self._recycle_evictable()
        b = self.blocks[idx]
        assert b.ref_count == 0
        b.token_hash = token_hash
        self.prefix_index[token_hash] = idx
        self._evictable[idx] = None   # ref 0: the caller forks to resurrect
        self.tier_store.promotions += 1
        return idx

    @property
    def prefix_hit_rate(self) -> float:
        """Cumulative block-level hit rate; routing computes windowed
        rates from the scraped totals instead of this lifetime ratio."""
        return self.prefix_hits / max(self.prefix_queries, 1)

    @property
    def utilization(self) -> float:
        used = sum(1 for b in self.blocks if b.ref_count > 0)
        return used / max(self.num_blocks, 1)


def chain_hash(prev: int, tokens: tuple) -> int:
    # repro-lint: disable-next-line=R1(ints/int-tuples only; unsalted, so chain hashes are run-stable)
    return hash((prev, tokens))


@dataclass
class KVHandoff:
    """Serialisable description of a prefilled request's sealed KV blocks,
    produced by a prefill-only engine and imported by a decode-only engine
    (disaggregated serving, repro.core.disagg).

    The wire form carries content hashes, not tensors: the simulator's KV
    blocks are content-addressed (`BlockAllocator.prefix_index`), so the
    receiver re-materialises the blocks by sealing empty ones under the
    same chain hashes and lets `SequenceKV.match_prefix` reattach them.
    ``kv_bytes`` is the physical transfer size a real system would move
    (roofline `kv_bytes_per_token` x covered tokens); the gateway charges
    it against the deployment's transfer-bandwidth knob.  The final prompt
    tokens past the last complete block (< block_size + 1 of them) are
    recomputed on the decode side, like a real partial-block handoff.
    """
    block_hashes: list            # chain hash per complete prompt block
    block_size: int
    tokens_covered: int           # == len(block_hashes) * block_size
    prompt_len: int
    first_token: int              # sampled on the prefill instance (TTFT)
    kv_bytes: float = 0.0

    def to_dict(self) -> dict:
        return {"block_hashes": list(self.block_hashes),
                "block_size": self.block_size,
                "tokens_covered": self.tokens_covered,
                "prompt_len": self.prompt_len,
                "first_token": self.first_token,
                "kv_bytes": self.kv_bytes}

    @classmethod
    def from_dict(cls, d: dict) -> "KVHandoff":
        return cls(block_hashes=list(d["block_hashes"]),
                   block_size=d["block_size"],
                   tokens_covered=d["tokens_covered"],
                   prompt_len=d["prompt_len"],
                   first_token=d["first_token"],
                   kv_bytes=d.get("kv_bytes", 0.0))


def export_handoff(tokens: list, block_size: int, first_token: int,
                   kv_bytes_per_token: float = 0.0) -> KVHandoff:
    """Build the handoff for a fully prefilled prompt: chain hashes of every
    complete block `match_prefix` could reuse (the final prompt token is
    never covered, mirroring match_prefix's contract)."""
    n_blocks = (len(tokens) - 1) // block_size
    hashes = []
    h = 0
    for i in range(n_blocks):
        h = chain_hash(h, tuple(tokens[i * block_size:(i + 1) * block_size]))
        hashes.append(h)
    covered = n_blocks * block_size
    return KVHandoff(block_hashes=hashes, block_size=block_size,
                     tokens_covered=covered, prompt_len=len(tokens),
                     first_token=first_token,
                     kv_bytes=float(covered) * kv_bytes_per_token)


class HandoffBlockSizeMismatch(ValueError):
    """A `KVHandoff` whose chain hashes were computed under a different
    ``block_size`` than the importing allocator's.  Sealing such hashes
    would content-address chunks no real `match_prefix` walk can ever
    produce (a silent mis-seal polluting the prefix index), so the import
    is rejected loudly and the caller decides whether to degrade to a
    full recompute (`LLMEngine.add_request` does, and counts it)."""

    def __init__(self, expected: int, got: int):
        super().__init__(f"handoff block_size {got} does not match "
                         f"allocator block_size {expected}")
        self.expected = expected
        self.got = got


def _resident(alloc: BlockAllocator, token_hash: int) -> bool:
    """Counter-free residency probe: like `lookup` but without touching
    the prefix-hit counters (import dedup probes are not client queries —
    counting them would inflate the hit rate slo_cost routing scrapes)."""
    idx = alloc.prefix_index.get(token_hash)
    return idx is not None and alloc.blocks[idx].token_hash == token_hash


def import_handoff(alloc: BlockAllocator, handoff: KVHandoff) -> int:
    """Materialise a handoff into `alloc`'s content-addressed index so the
    next `match_prefix` of the prompt hits.  Blocks already present (an
    earlier request with the same, possibly partial, prefix) are
    deduplicated against the resident index without counter side effects.
    Imports only consume truly free blocks — never the warm evictable
    pool (evicting resident prefix cache for an incoming transfer would
    trade a certain hit for a speculative one), and running out stops the
    import early: the uncovered suffix is simply recomputed.  Returns the
    number of blocks newly imported.  Raises `HandoffBlockSizeMismatch`
    when the handoff was exported under a different block size."""
    if handoff.block_size != alloc.block_size:
        raise HandoffBlockSizeMismatch(alloc.block_size, handoff.block_size)
    if not alloc.enable_prefix_caching:
        return 0
    imported = 0
    for h in handoff.block_hashes:
        if _resident(alloc, h):
            continue                    # transfer dedup: receiver has it
        if not alloc.free_list:
            break
        idx = alloc.allocate()          # pops the free list (checked above)
        alloc.seal(idx, h)
        alloc.free(idx)                 # sealed + ref 0 -> evictable pool
        imported += 1
    return imported


class SequenceKV:
    """Block table for one sequence."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self.block_table: list[int] = []
        self.num_tokens = 0
        self._hash_chain = 0          # rolling prefix hash
        self._owned_from = 0          # blocks [0, _owned_from) are shared

    def blocks_needed(self, new_tokens: int) -> int:
        bs = self.alloc.block_size
        total = self.num_tokens + new_tokens
        need = -(-total // bs)
        return max(0, need - len(self.block_table))

    def match_prefix(self, tokens: list) -> int:
        """Try content-addressed reuse of complete prompt blocks.
        Returns number of tokens covered by shared blocks. The final prompt
        token is never covered (its forward pass must run for logits)."""
        bs = self.alloc.block_size
        assert self.num_tokens == 0
        h = 0
        covered = 0
        for i in range((len(tokens) - 1) // bs):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            h = chain_hash(h, chunk)
            idx = self.alloc.lookup(h)
            if idx is None:
                break
            self.alloc.fork(idx)
            self.block_table.append(idx)
            covered += bs
        self._hash_chain = h if covered else 0
        self.num_tokens = covered
        self._owned_from = len(self.block_table)
        return covered

    def append_tokens(self, n: int, token_ids: Optional[list] = None):
        """Reserve space for n new tokens (allocating blocks as needed) and
        advance the fill pointer. token_ids (when given) seal completed
        blocks for prefix reuse."""
        bs = self.alloc.block_size
        need = self.blocks_needed(n)
        for _ in range(need):
            self.block_table.append(self.alloc.allocate())
        start = self.num_tokens
        self.num_tokens += n
        if token_ids is not None and self.alloc.enable_prefix_caching:
            # seal any block that just became complete
            first_complete = start // bs
            last_complete = self.num_tokens // bs
            for bi in range(first_complete, last_complete):
                if bi < self._owned_from:
                    continue
                chunk = tuple(token_ids[bi * bs:(bi + 1) * bs])
                if len(chunk) < bs:
                    break
                self._hash_chain = chain_hash(self._hash_chain, chunk)
                self.alloc.seal(self.block_table[bi], self._hash_chain)

    def extend_match(self, tokens: list) -> int:
        """Leapfrog prefill using blocks sealed by OTHER sequences since
        admission (called every scheduling round while prefilling). Only
        applies when the fill pointer sits exactly at a block boundary and
        the hash chain is intact; never covers the final prompt token."""
        bs = self.alloc.block_size
        if not self.alloc.enable_prefix_caching or self.num_tokens % bs:
            return self.num_tokens
        i = len(self.block_table)
        if i * bs != self.num_tokens:
            return self.num_tokens
        h = self._hash_chain
        while (i + 1) * bs <= len(tokens) - 1:
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            nh = chain_hash(h, chunk)
            idx = self.alloc.lookup(nh)
            if idx is None:
                break
            self.alloc.fork(idx)
            self.block_table.append(idx)
            h = nh
            i += 1
            self.num_tokens += bs
        self._hash_chain = h
        self._owned_from = len(self.block_table)
        return self.num_tokens

    def release(self):
        for idx in self.block_table:
            self.alloc.free(idx)
        self.block_table = []
        self.num_tokens = 0
        self._hash_chain = 0
        self._owned_from = 0

    @property
    def num_blocks(self) -> int:
        return len(self.block_table)
