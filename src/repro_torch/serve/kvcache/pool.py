"""Refcounted block-pool allocator with radix prefix sharing + LRU eviction.

Host-side bookkeeping for the paged KV cache: the *contents* of blocks live
in a device arena (see :mod:`repro_torch.serve.kvcache.paged`); this module owns
which blocks exist, who references them, and which token prefixes they hold.

Design (vLLM-style, adapted to the slot batcher):

  blocks     fixed-size spans of ``block_size`` token positions.  Block 0 is
             reserved as the *trash* block — inactive decode lanes scatter
             their (masked, garbage) writes there so the batched decode stays
             one fixed-shape call.
  refcounts  every live request holds one reference per block in its table.
             Shared prefix blocks carry refcount > 1 and are read-only; a
             write to a shared block must copy first (copy-on-write, handled
             by the adapter with a spare block reserved at admission).
  radix map  a chain-hash index over *full* prompt blocks:
             ``key_j = H(key_{j-1} || tokens[j*bs:(j+1)*bs])``, so a lookup
             walks the prompt left-to-right and stops at the first miss —
             exactly a radix-tree descent, stored flat.  A trailing partial
             prompt chunk gets a separate ``H(chain || chunk || '#p')`` entry
             that is dropped the moment any write lands on its block (decode
             extends partial blocks in place; full blocks are never written
             again, so their entries are permanent until evicted).
  LRU        a block whose refcount drops to zero but is still indexed is not
             freed — it parks in an LRU so a later request with the same
             prefix can revive it.  Allocation pops the free list first, then
             evicts from the cold end of the LRU (unindexing the key).
  protected  chain keys marked hot by the owner (the disaggregated gateway
             protects a handed-off prompt chain on its owning decode slice).
             Eviction scans the LRU cold-to-hot for the first *unprotected*
             block; only when every parked block is protected does it fall
             back to plain cold-end eviction (allocation never fails because
             of protection — it is a preference, not a pin).

Admission math: a request needs ``ceil((P + max_new) / bs)`` blocks worst
case; every *full*-block prefix hit removes one from that demand (a partial
hit does not — its copy-on-write spare takes the place of the block it
shares).  ``BlockPool.available()`` counts free + evictable blocks, so the
adapter's ``can_admit`` is exact, not heuristic.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np

TRASH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be served even after eviction."""


def chain_keys(tokens: np.ndarray, block_size: int
               ) -> tuple[list[bytes], bytes | None]:
    """(full-block chain keys, partial-chunk key or None) for a prompt."""
    tokens = np.asarray(tokens, np.int32)
    n_full = len(tokens) // block_size
    keys: list[bytes] = []
    h = b"root"
    for j in range(n_full):
        chunk = tokens[j * block_size:(j + 1) * block_size]
        h = hashlib.sha1(h + chunk.tobytes()).digest()
        keys.append(h)
    rest = tokens[n_full * block_size:]
    partial = None
    if len(rest):
        partial = hashlib.sha1(h + rest.tobytes() + b"#p").digest()
    return keys, partial


class BlockPool:
    """Refcounted fixed-size block allocator with a prefix index + LRU."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 2, "need at least the trash block + one real one"
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: deque[int] = deque(range(1, num_blocks))
        self.refcount = np.zeros(num_blocks, np.int64)
        self.index: dict[bytes, int] = {}        # chain/partial key -> block
        self.block_key: dict[int, bytes] = {}    # inverse (for eviction)
        self.partial_blocks: set[int] = set()    # indexed-partial block ids
        self.lru: OrderedDict[int, None] = OrderedDict()  # evictable blocks
        self.protected: set[bytes] = set()       # eviction-deprioritized keys
        # observer: called as on_unindex(bid, key) whenever a key leaves the
        # index (eviction / partial invalidation) — the paged adapter hangs
        # its per-boundary recurrent-state side cache off this, so that
        # cache can never outlive the blocks it describes
        self.on_unindex = None
        # counters (surfaced through gateway telemetry)
        self.evictions = 0
        self.protected_evictions = 0
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.cow_copies = 0

    # -- capacity ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the reserved trash block)."""
        return self.num_blocks - 1

    def available(self) -> int:
        """Blocks an allocation burst could obtain: free + evictable."""
        return len(self.free) + len(self.lru)

    def blocks_in_use(self) -> int:
        """Blocks referenced by live requests (excludes parked LRU blocks)."""
        return self.capacity - self.available()

    # -- allocation / refcounting ------------------------------------------
    def alloc(self) -> int:
        """Allocate a fresh block (refcount 1), evicting LRU if needed.

        Eviction is affinity-aware: the coldest *unprotected* block goes
        first, so hot shared prefix chains a decode slice owns stay
        resident under allocation pressure.  With every parked block
        protected, the cold end goes anyway — protection never turns an
        otherwise-satisfiable allocation into :class:`PoolExhausted`."""
        if self.free:
            bid = self.free.popleft()
        elif self.lru:
            bid = next((c for c in self.lru                # cold -> hot
                        if self.block_key.get(c) not in self.protected),
                       None)
            if bid is None:                                # all protected
                bid = next(iter(self.lru))
                self.protected_evictions += 1
            self.lru.pop(bid)
            self._unindex(bid)
            self.evictions += 1
        else:
            raise PoolExhausted(
                f"no free or evictable blocks (capacity {self.capacity})")
        self.refcount[bid] = 1
        return bid

    def acquire(self, bid: int) -> int:
        """Take a reference on an existing block (prefix hit / fork)."""
        if self.refcount[bid] == 0:            # revive from the LRU
            self.lru.pop(bid, None)
        self.refcount[bid] += 1
        return bid

    def release(self, bid: int) -> None:
        if bid == TRASH_BLOCK:
            return
        assert self.refcount[bid] > 0, f"double free of block {bid}"
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            if bid in self.block_key:
                self.lru[bid] = None           # evictable, contents cached
                self.lru.move_to_end(bid)
            else:
                self.free.append(bid)

    # -- prefix index ------------------------------------------------------
    def lookup(self, key: bytes, count: bool = True) -> int | None:
        """Index probe; ``count=False`` keeps admission pre-checks out of
        the hit-rate telemetry (only real admissions are queries)."""
        bid = self.index.get(key)
        if count:
            self.prefix_queries += 1
            if bid is not None:
                self.prefix_hits += 1
        return bid

    def register(self, key: bytes, bid: int, *, partial: bool = False) -> None:
        """Make a freshly-written prompt block findable by later requests."""
        if key in self.index:                  # racing identical prompts:
            return                             # keep the first registration
        self.index[key] = bid
        self.block_key[bid] = key
        if partial:
            self.partial_blocks.add(bid)

    def is_partial(self, bid: int) -> bool:
        return bid in self.partial_blocks

    def drop_partial(self, bid: int) -> None:
        """Invalidate a partial entry before its block is written in place."""
        if bid in self.partial_blocks:
            self._unindex(bid)

    def _unindex(self, bid: int) -> None:
        key = self.block_key.pop(bid, None)
        if key is not None:
            self.index.pop(key, None)
            self.protected.discard(key)
            if self.on_unindex is not None:
                self.on_unindex(bid, key)
        self.partial_blocks.discard(bid)

    # -- eviction protection -----------------------------------------------
    def protect(self, keys) -> None:
        """Mark chain keys hot: their blocks are evicted last (see
        :meth:`alloc`).  Keys not (or no longer) indexed are skipped —
        protection tracks residency, it does not create it."""
        for key in keys:
            if key in self.index:
                self.protected.add(key)

    def unprotect(self, keys) -> None:
        for key in keys:
            self.protected.discard(key)

    # -- prefix matching ---------------------------------------------------
    def probe_chain(self, keys: list[bytes], pkey: bytes | None = None,
                    count: bool = True) -> tuple[list[int], int | None]:
        """Walk precomputed chain keys (see :func:`chain_keys`).

        Returns (full-block hits in prefix order, partial hit or None).
        Pure probe, no references taken.  The sharded gateway router hashes
        a prompt once and probes every slice's pool with the same keys —
        radix-prefix affinity routing without re-hashing per slice.
        """
        hits: list[int] = []
        for key in keys:
            bid = self.lookup(key, count=count)
            if bid is None:
                break
            hits.append(bid)
        partial_hit = None
        if pkey is not None and len(hits) == len(keys):
            partial_hit = self.lookup(pkey, count=count)
        return hits, partial_hit

    def match_prefix(self, tokens: np.ndarray, count: bool = True
                     ) -> tuple[list[int], int | None, list[bytes],
                                bytes | None]:
        """Walk the radix chain for ``tokens``.

        Returns (full-block hits in prefix order, partial-block hit or None,
        all full-block chain keys, partial key or None).  Pure probe: takes
        no references — the caller acquires on admission.
        """
        keys, pkey = chain_keys(tokens, self.block_size)
        hits, partial_hit = self.probe_chain(keys, pkey, count=count)
        return hits, partial_hit, keys, pkey

    def shared_chains(self, lane_chains: dict, *, min_lanes: int = 2,
                      skip=()) -> list[tuple[tuple[int, ...], list]]:
        """Group decode lanes by their longest shared indexed prefix chain.

        ``lane_chains`` maps a lane id to that lane's *full*-block ids in
        prefix order (the caller trims the partially-filled tail block —
        only positions every sharer can read may enter a cascade group).
        A block is cascade-eligible iff it is indexed as a full block
        (partials are rewritten in place by their sole owner), actually
        shared (refcount >= 2 — a private chain gains nothing from a group
        pass), not ``protected`` (a handed-off chain may still be mid-
        migration rewrite on this slice), and not in ``skip`` (the adapter
        passes blocks armed for copy-on-write).  Each lane contributes its
        longest eligible prefix; lanes with the *identical* chain tuple
        form a group.  Returns ``[(chain, [lane, ...]), ...]`` for groups
        of at least ``min_lanes`` lanes, deterministic in lane order.
        """
        skip = set(skip)

        def eligible(bid: int) -> bool:
            if bid == TRASH_BLOCK or bid in skip:
                return False
            key = self.block_key.get(bid)
            if key is None or bid in self.partial_blocks:
                return False
            return self.refcount[bid] >= 2 and key not in self.protected

        by_chain: dict[tuple[int, ...], list] = {}
        for lane, chain in lane_chains.items():
            shared = []
            for bid in chain:
                if not eligible(bid):
                    break
                shared.append(int(bid))
            if shared:
                by_chain.setdefault(tuple(shared), []).append(lane)
        return [(chain, lanes) for chain, lanes in by_chain.items()
                if len(lanes) >= min_lanes]

    # -- telemetry ---------------------------------------------------------
    def gauges(self) -> dict:
        """Instantaneous occupancy gauges for pull-mode interval sampling
        (serve/obs ``MetricsRegistry.register``) — the cheap subset of
        :meth:`stats`, read once per snapshot tick."""
        q = self.prefix_queries
        return {
            "pool_blocks_in_use": int(self.blocks_in_use()),
            "pool_blocks_cached": len(self.lru),
            "prefix_hit_rate": (self.prefix_hits / q) if q else 0.0,
        }

    def stats(self) -> dict:
        q = self.prefix_queries
        return {
            "num_blocks": self.capacity,
            "block_size": self.block_size,
            "blocks_in_use": int(self.blocks_in_use()),
            "blocks_cached": len(self.lru),
            "blocks_free": len(self.free),
            "prefix_queries": q,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / q) if q else 0.0,
            "evictions": self.evictions,
            "protected_keys": len(self.protected),
            "protected_evictions": self.protected_evictions,
            "cow_copies": self.cow_copies,
        }

    def debug_snapshot(self) -> dict:
        """Forensic pool state for incident bundles (serve/obs/incident.py):
        :meth:`stats` plus index/LRU/partial sizes and the refcount shape —
        aggregate counts only, never block contents, so bundles stay small
        and free of request payload data."""
        snap = self.stats()
        rc = self.refcount[1:]                   # trash block excluded
        snap.update({
            "index_keys": len(self.index),
            "lru_parked": len(self.lru),
            "partial_blocks": len(self.partial_blocks),
            "free_blocks": len(self.free),
            "max_refcount": int(rc.max()) if rc.size else 0,
            "referenced_blocks": int((rc > 0).sum()),
        })
        return snap
