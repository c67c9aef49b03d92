"""Cross-slice block migration: move a live request between gateway slices.

A migration rebuilds a request's paged context on the destination slice's
pool and arena and releases it from the source: the mechanism behind the
sharded gateway's rebalancing and, under a ``RolePlan``, the prefill ->
decode handoff (``serve/shard/router.py``).  The contract is the
reference's (``repro.serve.shard.migrate``):

  exactness     the destination lane decodes the same bits the request
                would have produced had it stayed: every block's contents,
                the slot's state row (its length, the hybrid conv / SSM
                state, the encdec and vlm cross K/V) and the generated
                tail carry over unchanged, and the destination tick runs
                the same fixed-shape captured step (slices share
                ``n_slots``).

  sharing       full prompt blocks re-enter the destination pool's radix
                index: a chain block the destination already indexes is
                referenced (refcount + 1, no bytes moved) instead of
                copied, and the moved prompt becomes hit-able there.

  copy-on-write a source slot still holding a shared partial block with a
                pending copy-on-write spare gets the copy materialized (its
                contents land in a private destination block); the source
                sibling keeps the original and the spare is released with
                the source slot.

Bytes cross through the host (a copy to host memory and back), the path a
gateway spread over machines would pay; the receipt's byte count is
charged to the request's energy ledger through
``frontend.migration_energy_nj``.  Under ``kv_quant`` the int8 codes and
their float32 scales are arena keys alike, so both move.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.kvcache.pool import (TRASH_BLOCK, PoolExhausted,
                                            chain_keys)

# the slot's length rides the state row as the reference's slot-stacked
# int32 scalar
LEN_BYTES = 4


@dataclasses.dataclass(frozen=True)
class MigrationReceipt:
    blocks_total: int            # blocks in the request's table
    blocks_moved: int            # copied through the host
    blocks_shared: int           # satisfied by the destination radix index
    bytes_moved: int             # arena block bytes + slot-state row bytes

    def trace_args(self, src_idx: int, dst_idx: int) -> dict:
        """Args for the router's ``migrate`` span (``serve/obs``): where the
        request moved and what the move cost on the wire."""
        return {"src": src_idx, "dst": dst_idx, "bytes": self.bytes_moved,
                "blocks_moved": self.blocks_moved,
                "blocks_shared": self.blocks_shared}


def _check(src, slot: int, dst, dst_slot: int) -> None:
    """The reference's preconditions (``ValueError`` where it asserts)."""
    if src.cfg != dst.cfg:
        raise ValueError("migration across configs")
    if src.bs != dst.bs or src.nb_max != dst.nb_max:
        raise ValueError("migration across block geometries")
    if dst.slot_bids[dst_slot]:
        raise ValueError(f"dst slot {dst_slot} not free")
    if not src.slot_bids[slot]:
        raise ValueError(f"src slot {slot} holds no blocks")


def migrate_slot(src, slot: int, dst, dst_slot: int,
                 prompt: np.ndarray) -> MigrationReceipt:
    """Move ``src``'s ``slot`` onto ``dst``'s free ``dst_slot``.

    ``src`` / ``dst`` are ``PagedKVSlotAdapter``s of the same config and
    block geometry; ``prompt`` is the request's original prompt (the radix
    chain keys are recomputed from it, so the destination can reference
    blocks it already indexes).  On ``PoolExhausted`` during allocation, or
    any failure mid-copy, the destination is rolled back (its new blocks
    released, only this migration's index entries undone) and the source
    is left untouched, radix index included."""
    _check(src, slot, dst, dst_slot)
    prompt = np.asarray(prompt, np.int32)
    bids = src.slot_bids[slot]
    n_full = len(prompt) // src.bs
    keys, _ = chain_keys(prompt, src.bs)

    # the destination's blocks first (allocation can fail; the source must
    # survive): full prompt blocks it already indexes are referenced,
    # everything else (unindexed prompt blocks, the partial prompt block,
    # generation blocks) gets a fresh private block
    dst_bids: list[int] = []
    fresh: list[tuple[int, bytes | None, int]] = []   # (chain idx, key, bid)
    shared = 0
    try:
        for j in range(len(bids)):
            key = keys[j] if j < n_full else None
            hit = dst.pool.lookup(key, count=False) if key is not None \
                else None
            if hit is not None:
                dst_bids.append(dst.pool.acquire(hit))
                shared += 1
            else:
                b = dst.pool.alloc()
                fresh.append((j, key, b))
                dst_bids.append(b)
    except PoolExhausted:
        for b in dst_bids:
            dst.pool.release(b)
        raise

    # block contents cross through the host.  Only blocks holding written
    # rows move: the chain's reserved generation tail holds no data yet,
    # and copying it would inflate the byte count (and the energy charged)
    block_bytes = src._token_bytes * src.bs
    live = -(-int(src.lens[slot]) // src.bs)
    moved = 0
    n_copied = 0
    try:
        for j, key, b in fresh:
            if j >= live:
                continue
            dst.write_block(b, {k: src.arena_block(k, bids[j]).cpu()
                                for k in src.seq_keys})
            moved += block_bytes
            n_copied += 1
            if key is not None:
                # full prompt blocks are immutable from here on (the write
                # position is past them): index them so later destination
                # admissions hit this chain
                dst.pool.register(key, b)
        # the slot's state row: its length, the hybrid conv / SSM state,
        # the encdec and vlm cross K/V (in place: the captured ticks read
        # these tensors)
        moved += LEN_BYTES
        for k, a in dst.state.items():
            row = src.state[k][:, slot].cpu()
            a[:, dst_slot].copy_(row)
            moved += row.numel() * row.element_size()
    except BaseException:
        # a mid-copy failure (the cross-host hop is the fallible part of a
        # handoff): unindex only the chain keys whose entry points at a
        # block this migration allocated (registration is first-wins, so
        # an older entry for the same key is another request's), then drop
        # every destination reference taken above.  Nothing below ran, and
        # the source is cleared only after the commit, so both slices read
        # back as they were
        ours = {b for _, _, b in fresh}
        for key in keys[:n_full]:
            if dst.pool.index.get(key) in ours:
                dst.pool._unindex(dst.pool.index[key])
        for b in dst_bids:
            dst.pool.release(b)
        raise

    dst.tables[dst_slot, :] = TRASH_BLOCK
    dst.tables[dst_slot, :len(dst_bids)] = dst_bids
    dst.lens[dst_slot] = src.lens[slot]
    dst.slot_bids[dst_slot] = dst_bids
    dst._stats[dst_slot] = dict(src._stats[slot])
    dst._update_peaks()

    # hybrid: the boundary states ride along for the chain keys now indexed
    # on the destination (a resume there needs them); after the commit, so
    # a rolled-back migration leaves none behind, under the same bound the
    # fold's save path keeps
    if src._boundary_states:
        for key in keys[:n_full]:
            st = src._boundary_states.get(key)
            if st is not None and key in dst.pool.index and \
                    key not in dst._boundary_states:
                dst._boundary_states[key] = {
                    k: a.cpu().to(dst.device) for k, a in st.items()}
                dst._boundary_states.move_to_end(key)
        while len(dst._boundary_states) > dst._max_boundary_states:
            dst._boundary_states.popitem(last=False)

    # release the source slot (its references; a pending copy-on-write
    # spare, the copy the migration just materialized, goes with it)
    src.clear(slot)
    return MigrationReceipt(blocks_total=len(bids), blocks_moved=n_copied,
                            blocks_shared=shared, bytes_moved=moved)
