"""Block-table-backed KV slots: the paged KV cache of the prompt path.

Layout
    One preallocated arena per sequence key on the adapter's device —
    ``arena[key]: (L, num_blocks, 1, bs, Hkv, Dh)`` from
    :func:`engine.init_paged_arena` — shared by every slot.  Each slot holds
    a block table (a row of ``(n_slots, nb_max)`` int32) mapping logical
    block j to an arena block id.  Tables and lengths are host numpy state,
    as in the reference.

Decode tick
    :func:`engine.decode_step_paged` reads K/V in place through the block
    tables in every attention layer and writes exactly one row per layer
    and lane (in place).  Inactive lanes, at-capacity lanes and lanes not
    yet past copy-on-write write the reserved trash block 0, so the call
    never changes shape.

Cascade tick (``backend="cascade"``)
    After the copy-on-write loop, the live lanes are grouped by the longest
    chain of shared, indexed full blocks they hold in common
    (:meth:`BlockPool.shared_chains`); each group's chain is attended once
    per layer for all its lanes, and each lane's remaining suffix on its
    own by a pass that merges the two softmax states in its epilogue
    (``nn.attention.attend_decode_cascade``).
    The group metadata is built on the host with pow2-padded shapes.  A
    tick with no chain shared by two lanes runs the device's flat tick
    unchanged.

Captured ticks
    Each tick is a captured step (``serve/capture.py``), the reference's
    jitted ``_decode`` and ``_decode_cascade``: one CUDA graph for the flat
    tick and one per cascade metadata bucket (the pow2-padded group, chain,
    lane and suffix counts), replayed with the tick's host inputs (tokens,
    tables, lengths, write targets, for the hybrid family the active
    lanes, and the group metadata) refilled by one copy from pinned
    memory.  The copy-on-write copy, the prompt writes, the encoder,
    the fold and one-shot prefill stay eager, on the same stream.  The
    graphs read the lane state (``state``) where it lies, so an admission
    copies its state into the slot in place, never rebinding a tensor.

Chunked prefill (``chunked=True``, the default): prefix-hit compute
skipping
    Admission prefills a prompt as a *fold* of block-size chunks through
    :func:`engine.prefill_chunked`: chunk j extends the KV prefix of j*bs
    positions by one block.  A radix prefix hit of H blocks gathers those
    blocks from the arena and resumes the fold at chunk H, so the shared
    prompt's transformer work is skipped, not just its storage.  Chunk j
    runs the same operations on the same inputs whether the fold started at
    0 or at H, so a resumed prefill is bitwise identical to the cold one:
    same logits, same written blocks.  The trailing partial chunk is always
    recomputed into a block of the slot's own, so nothing is shared
    read-only and nothing is copied on write.

Boundary states (the hybrid family)
    An SSM stream resumes mid-prompt only from its recurrent state at the
    resume point.  The fold snapshots the state (conv taps and SSM state
    of every layer) at each full-block boundary whose chain key has none
    yet (the chunk's own state tensors, which no later chunk, tick or
    capture writes: each chunk stacks new ones), and commits the snapshots after the prompt's blocks are written.  They
    live in an LRU capped at ``pool.capacity`` entries and leave with
    their key when the pool unindexes it (``pool.on_unindex``); a resume
    is capped at the deepest boundary whose snapshot is still held.
    ``pool_stats()["boundary_state_bytes"]`` reports the bytes they hold.
    Each lane's own state lives in ``state`` (L, n_slots, ...), which the
    ticks overwrite in place (an inactive lane's put back bit for bit).

Cross K/V (the encdec family)
    Each admission runs the encoder on the frame embeddings ``extras()``
    returns (:func:`engine.encode_cross`), a prefix hit too: the radix
    index keys on tokens alone and a hit skips decoder work only, as in
    the reference.  Every chunk of the fold reads that one encoding, and
    the lane keeps it in ``state["xk"]`` / ``state["xv"]`` (L, n_slots,
    enc_len, Hkv, Dh), which the ticks read.

Sharing / copy-on-write (one-shot prefill, ``chunked=False``)
    Admission walks the pool's radix index: full prompt blocks that match
    an earlier request's chain are referenced instead of written (their
    prefill values are discarded).  A trailing partial prompt block is
    shared too when the whole chain plus the partial chunk matches; since
    decode extends partial blocks in place, every holder of a shared
    partial block carries a pre-allocated *spare* and copies into it before
    its first write — the sibling keeps the original, bit for bit.

Admission control
    ``can_admit`` prices a request at its worst case, ``ceil((P + max_new)
    / bs)`` blocks minus full-prefix hits, plus one per hit revived from
    the LRU; the one-shot path adds the shared partial's revival and the
    copy-on-write spares it obliges (see ``_admission_demand``).  It admits
    only when the pool's free + evictable supply covers the demand.

Gather tick (``backend="gather"``)
    The reference's parity oracle for the in-place ticks: every lane's
    whole ``nb_max`` table is gathered into the dense layout, the dense
    tick runs on that copy (:func:`engine.decode_step`), and the block
    holding each lane's new row is scattered back to its write target
    (lanes out of range to the trash block).  Plain PyTorch on every
    device, captured like the flat tick.

Observability (``tracer``, wired by the prompt gateway for a run)
    Each fold chunk is a ``prefill_chunk`` span (``q0``, ``tokens``,
    ``prefix_hit``) on the admitting request's track, closed after a
    synchronize so it measures the chunk's work; a resume that skips
    blocks leaves a ``prefix_resume`` instant.  While a tracer is attached
    ``work`` sums each stage's FLOP and byte counts for ``cost_args``.
    Without one the adapter makes no obs call and no extra synchronize.

The reference's vlm family and mesh placement come with later slices
(ROADMAP.md).
"""
from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.models.lm import LMConfig
from repro_torch.serve import capture, engine
from repro_torch.serve.backend import auto_backend, resolve_backend
from repro_torch.serve.gateway.slots import check_extras, extras_kwargs
from repro_torch.serve.kvcache.pool import (TRASH_BLOCK, BlockPool,
                                            PoolExhausted)
from repro_torch.serve.obs import costmodel


# the cascade tick's group metadata, in the order its captured step takes
# it after the flat tick's inputs (see nn.attention.attend_decode_cascade)
CASCADE_META = ("group_tables", "group_len", "group_lanes", "group_mask",
                "lane_q0", "suffix_tables", "lane_lens", "group_dest",
                "lane_slot")

# the reference adapter's jitted entry points that the port runs eagerly
# or inside a captured tick, so ``jit_fns`` does not name them
NOT_CAPTURED = {
    "prefill": "eager: one-shot prefill, shapes change per prompt",
    "chunk_fold": "eager: the fold, shapes change per chunk; its resume "
                  "stays bitwise",
    "gather_prefix": "eager: a resumed fold's prefix, per prompt",
    "scatter": "eager: a prompt's block writes, per prompt",
    "copy": "eager: the copy-on-write copy, on the tick's stream",
    "write_block": "eager: block writes (no caller in the port yet)",
    "encode": "eager: the encoder, once per admission (encdec)",
    "cascade_prefix": "inside the captured cascade tick",
    "cascade_suffix": "inside the captured cascade tick",
    "cascade_merge": "inside the captured cascade tick (fused into the "
                     "suffix pass)",
}


def _flat_tick(cfg, params, arena, state, backend, tokens, tables, lens,
               wbids, active=None):
    """The flat tick's captured body: :func:`engine.decode_step_paged`
    (``active``, the lanes whose state the tick advances, for the hybrid
    family only)."""
    return engine.decode_step_paged(cfg, params, tokens, tables=tables,
                                    lens=lens, arena=arena, wbids=wbids,
                                    backend=backend, state=state,
                                    active=active)


def _gather_tick(cfg, params, arena, state, tokens, tables, lens, wbids,
                 active=None):
    """The gather tick's captured body (the reference's ``_tick_impl``):
    gather each lane's chain into a dense cache (L, S, nb_max * bs, Hkv,
    Dh), run :func:`engine.decode_step` on it (with the lanes' recurrent
    state, advanced in place for the lanes that write), and write the
    block that holds each lane's new row to ``wbids`` (a lane whose length
    is past its table writes the trash block, from offset 0); the encdec
    family's lanes read their cross K/V from ``state``."""
    S, nb = tables.shape
    bs = arena["k"].shape[-3]
    max_len = nb * bs
    idx = tables.long()
    cache = {"len": lens.clone(), **state}
    for key in engine.PAGED_SEQ_KEYS:
        g = arena[key][:, idx, 0]                # (L, S, nb, bs, Hkv, Dh)
        cache[key] = g.reshape(g.shape[0], S, max_len, *g.shape[4:])
    _, logits = engine.decode_step(cfg, params, cache, tokens, active)
    oor = lens >= max_len
    start = torch.where(oor, 0, lens // bs * bs).long()
    wbids = torch.where(oor, TRASH_BLOCK, wbids).long()
    rows = start[:, None] + torch.arange(bs, device=start.device)  # (S, bs)
    lanes = torch.arange(S, device=start.device)[:, None]
    for key in engine.PAGED_SEQ_KEYS:
        arena[key][:, wbids, 0] = cache[key][:, lanes, rows]
    return logits


def _cascade_tick(cfg, params, arena, state, tokens, tables, lens, wbids,
                  *rest):
    """The cascade tick's captured body: :func:`engine.decode_step_paged`
    with the group metadata, :data:`CASCADE_META` in order (after the
    ``active`` lanes for the hybrid family)."""
    active, meta = (rest[0], rest[1:]) if cfg.family == "hybrid" else \
        (None, rest)
    return engine.decode_step_paged(cfg, params, tokens, tables=tables,
                                    lens=lens, arena=arena, wbids=wbids,
                                    backend="cascade",
                                    cascade=dict(zip(CASCADE_META, meta)),
                                    state=state, active=active)


class PagedKVSlotAdapter:
    """Paged KV slots for the decoder, moe, hybrid and encdec families (the
    last with ``extras``, see ``slots.make_adapter``), with the
    batcher surface (``insert`` / ``decode`` / ``clear``) and the paging
    hooks the batcher discovers by presence: ``can_admit``,
    ``validate_request``, ``at_capacity``, ``slot_stats``,
    ``pool_stats``."""

    def __init__(self, cfg: LMConfig, params: dict, n_slots: int,
                 max_len: int, *, block_size: int = 16,
                 num_blocks: int | None = None, extras=None,
                 chunked: bool = True, backend: str | None = None):
        check_extras(cfg, extras)
        self.cfg = cfg
        self.extras = extras
        self.hybrid = cfg.family == "hybrid"
        self.chunked = chunked
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.bs = block_size
        self.nb_max = -(-max_len // block_size)
        self.max_len = self.nb_max * block_size
        self.backend = resolve_backend(backend, self.device)
        # what a tick runs when nothing is grouped: the flat tick of the
        # device, so a cascade tick without a group is exactly that tick
        self.flat_backend = auto_backend(self.device) \
            if self.backend == "cascade" else self.backend
        self.last_groups = 0            # groups of the latest cascade tick
        if self.device.type == "cuda":
            # float32 matrix products in full float32, as the reference
            # computes them (TF32 would keep about three digits)
            torch.backends.cuda.matmul.allow_tf32 = False
        if num_blocks is None:
            # dense-equivalent capacity + the reserved trash block
            num_blocks = n_slots * self.nb_max + 1
        self.pool = BlockPool(num_blocks, block_size)
        self.arena = engine.init_paged_arena(cfg, num_blocks, block_size,
                                             self.device)
        self.seq_keys = tuple(self.arena)
        # the lanes' state: the hybrid family's recurrent state, the encdec
        # family's cross K/V ({} otherwise)
        self.state = engine.init_state(cfg, n_slots, self.device)
        # the hybrid family's boundary states (see the module docstring),
        # by chain key, least recently used first
        self._boundary_states: OrderedDict[bytes, dict] = OrderedDict()
        self._max_boundary_states = self.pool.capacity
        self.pool.on_unindex = \
            lambda bid, key: self._boundary_states.pop(key, None)
        self.prefill_tokens_total = 0
        self.prefill_tokens_skipped_total = 0
        self.prefill_chunks_total = 0       # fold steps run (chunked)
        # obs span recorder, wired by the prompt gateway for the length of
        # a run; every use is guarded, so a bare adapter makes zero obs
        # calls.  The batcher points the tracer's lane at the admitting
        # request before insert, so chunk spans land on it.
        self.tracer = None

        # host-side paging state
        self.tables = np.zeros((n_slots, self.nb_max), np.int32)
        self.lens = np.zeros(n_slots, np.int64)
        self.slot_bids: list[list[int]] = [[] for _ in range(n_slots)]
        self.cow_blk: list[int | None] = [None] * n_slots
        self.cow_spare: list[int | None] = [None] * n_slots
        self.partial_reg: list[tuple[int, int] | None] = [None] * n_slots
        self._stats: list[dict] = [{} for _ in range(n_slots)]
        # per-token arena bytes (for the bytes-saved-vs-dense telemetry)
        self._token_bytes = sum(
            a.element_size() * (a.numel() // num_blocks) // block_size
            for a in self.arena.values())
        self.peak_blocks_in_use = 0
        self.peak_bytes_saved = 0
        self.last_logits = None
        self.last_prefill_logits = None     # the latest insert's logits
        # the captured ticks (the steps close over the arena and weights,
        # never over the adapter), on one graph memory pool
        pool = capture.GraphPool(self.device)
        tick = functools.partial(_gather_tick, cfg, params, self.arena,
                                 self.state) \
            if self.backend == "gather" else \
            functools.partial(_flat_tick, cfg, params, self.arena,
                              self.state, self.flat_backend)
        self._decode = capture.CapturedStep(tick, self.device, pool)
        if self.backend == "cascade":
            self._decode_cascade = capture.CapturedStep(
                functools.partial(_cascade_tick, cfg, params, self.arena,
                                  self.state),
                self.device, pool)

    # -- device work ---------------------------------------------------------

    def _scatter(self, cache: dict,
                 fresh: list[tuple[int, bytes | None, int]]) -> None:
        """Write the freshly owned prompt blocks ``(j, key, bid)`` of a B=1
        prefill cache into the arena (a partial block's tail is zeros, as
        the reference's padded write leaves it); shared blocks keep the
        sibling's values."""
        if not fresh:
            return
        js = torch.tensor([j for j, _, _ in fresh], device=self.device)
        bids = torch.tensor([b for _, _, b in fresh], device=self.device)
        n = max(j for j, _, _ in fresh) + 1
        for key in self.seq_keys:
            a = cache[key][:, 0]                          # (L, P, Hkv, Dh)
            pad = n * self.bs - a.shape[1]
            if pad > 0:
                a = torch.cat([a, a.new_zeros((a.shape[0], pad)
                                              + a.shape[2:])], dim=1)
            blocks = a[:, :n * self.bs].reshape(
                a.shape[0], n, self.bs, *a.shape[2:])
            self.arena[key][:, bids, 0] = blocks[:, js]

    def _copy(self, dst: int, src: int) -> None:
        """Copy block ``src`` onto block ``dst`` for every key (CoW)."""
        for a in self.arena.values():
            a[:, dst] = a[:, src]

    # -- admission ----------------------------------------------------------

    def _block_demand(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.bs)

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        n_total = self._block_demand(prompt_len, max_new)
        if n_total > self.pool.capacity:
            raise ValueError(
                f"request needs {n_total} blocks worst-case; pool holds "
                f"{self.pool.capacity} (block_size={self.bs})")

    def _arming_demand(self, partial_hit: int | None) -> int:
        """Spares newly required by existing holders of a shared partial."""
        if partial_hit is None:
            return 0
        return sum(1 for s in range(self.n_slots)
                   if self.partial_reg[s]
                   and self.partial_reg[s][1] == partial_hit
                   and self.cow_spare[s] is None)

    def _admission_demand(self, prompt: np.ndarray, max_new: int) -> int:
        """Exact worst-case supply (free + evictable) an ``insert`` of this
        request consumes: the chain's blocks minus full-prefix hits, plus
        one per hit revived from the LRU.  The chunked fold recomputes the
        boundary chunk into the slot's own block (already counted), so a
        partial hit adds nothing; the one-shot path also holds the shared
        partial (its revival) and arms its existing holders' spares."""
        pool = self.pool
        n_total = self._block_demand(len(prompt), max_new)
        hits, partial_hit, _, _ = pool.match_prefix(
            np.asarray(prompt, np.int32), count=False)
        revived = sum(1 for b in hits if pool.refcount[b] == 0)
        demand = n_total - len(hits) + revived
        if self.chunked:
            return demand
        if partial_hit is not None and pool.refcount[partial_hit] == 0:
            demand += 1
        return demand + self._arming_demand(partial_hit)

    def can_admit(self, prompt: np.ndarray, max_new: int) -> bool:
        """Worst-case block demand vs free + evictable supply; the batcher
        queues the request when it does not fit (never fails mid-flight)."""
        return self._admission_demand(prompt, max_new) <= \
            self.pool.available()

    # -- slot lifecycle ------------------------------------------------------

    def insert(self, slot: int, prompt: np.ndarray,
               max_new: int | None = None) -> int:
        """Prefill ``prompt`` into ``slot`` (the chunked fold, or one-shot
        with ``chunked=False``).  Returns the first generated token."""
        P = len(prompt)
        if max_new is None:
            max_new = max(1, self.max_len - P)
        if P + max_new > self.max_len:
            raise ValueError(f"prompt {P} + {max_new} new tokens exceeds "
                             f"slot capacity {self.max_len}")
        prompt = np.asarray(prompt, np.int32)
        n_total = self._block_demand(P, max_new)
        n_full = P // self.bs
        hits, partial_hit, keys, pkey = self.pool.match_prefix(prompt)
        insert = self._insert_chunked if self.chunked else \
            self._insert_oneshot
        return insert(slot, prompt, n_total, n_full, hits, partial_hit,
                      keys, pkey)

    def _resume_blocks(self, P: int, hits: list[int],
                       keys: list[bytes]) -> int:
        """How many prefix blocks the fold skips: the hit chain, capped so
        that at least one prompt token remains (the fold must produce the
        last token's logits) and, for the hybrid family, at the deepest
        boundary whose state is still held."""
        H = len(hits)
        while H > 0 and (H * self.bs >= P or (
                self.hybrid and keys[H - 1] not in self._boundary_states)):
            H -= 1
        return H

    def _gather_prefix(self, bids: list[int]) -> dict[str, torch.Tensor]:
        """An H-block chain in the layout :func:`engine.prefill_chunked`
        consumes: per key (L, 1, H*bs, Hkv, Dh), copied out of the arena."""
        idx = torch.tensor(bids, device=self.device)
        out = {}
        for key in self.seq_keys:
            g = self.arena[key][:, idx, 0]         # (L, H, bs, Hkv, Dh)
            out[key] = g.reshape(g.shape[0], 1, -1, *g.shape[3:])
        return out

    def _encode(self) -> dict[str, torch.Tensor]:
        """The encdec family's cross K/V for one admission, each (L, 1,
        enc_len, Hkv, Dh), from the frame embeddings ``extras()`` returns;
        {} for the other families."""
        kw = extras_kwargs(self.cfg, self.extras, self.device)
        if not kw:
            return {}
        return dict(zip(engine.CROSS_KEYS, engine.encode_cross(
            self.cfg, self.params, kw["enc_embed"])))

    def _prefix_cache(self, bids: list[int], state: dict | None = None
                      ) -> dict[str, torch.Tensor]:
        """The prefix cache a fold starts from: the gathered blocks
        ``bids`` with the boundary ``state`` (hybrid), or an empty cache
        (zero state) for a cold fold; for the encdec family with the
        admission's cross K/V (the encoder runs on a hit too)."""
        cache = {**self._gather_prefix(bids), **(state or {})} if bids \
            else engine.empty_cache(self.cfg, 1, self.device)
        return {**cache, **self._encode()}

    def _fold_prefill(self, prompt: np.ndarray, q0: int, cache: dict,
                      keys: list[bytes]
                      ) -> tuple[dict, torch.Tensor, list[tuple]]:
        """Run the chunk fold over ``prompt[q0:]``, one block-size chunk per
        step.  Returns (the final cache, the last token's logits, and for
        the hybrid family a copy of the state at each full-block boundary
        whose key ``keys[j]`` holds none yet, as (key, state) to commit
        once the prompt's blocks are written)."""
        P = len(prompt)
        n_full = P // self.bs
        tokens = torch.from_numpy(prompt[None]).to(self.device)
        q, logits = q0, None
        snapshots: list[tuple[bytes, dict]] = []
        while q < P:
            c = min(self.bs, P - q)
            if self.tracer is not None:
                self.tracer.begin("prefill_chunk")
            cache, logits = engine.prefill_chunked(
                self.cfg, self.params, tokens[:, q:q + c], cache, q)
            if self.tracer is not None:
                # the span closes on the chunk's finished work, not on
                # its issue
                synchronize(self.device)
                self.tracer.end("prefill_chunk",
                                args={"q0": q, "tokens": c,
                                      "prefix_hit": False})
            self.prefill_chunks_total += 1
            q += c
            j = q // self.bs - 1
            if (self.hybrid and q % self.bs == 0 and j < n_full
                    and keys[j] not in self._boundary_states):
                # no copy: prefill_chunked stacks new state tensors every
                # chunk and only reads the ones it is given, and
                # _set_state copies into the slot's state
                snapshots.append((keys[j], {
                    key: cache[key] for key in engine.STATE_KEYS}))
        return cache, logits, snapshots

    def _commit_snapshots(self, snapshots: list[tuple]) -> None:
        """Hold the fold's boundary states, most recent last, and drop the
        least recently used past the cap."""
        for key, st in snapshots:
            self._boundary_states.setdefault(key, st)
            self._boundary_states.move_to_end(key)
        while len(self._boundary_states) > self._max_boundary_states:
            self._boundary_states.popitem(last=False)

    def _set_state(self, slot: int, cache: dict) -> None:
        """The slot's lane state after its prefill (the hybrid family's
        recurrent state, the encdec family's cross K/V), copied in place:
        the captured ticks read these tensors."""
        for key, a in self.state.items():
            a[:, slot] = cache[key][:, 0]

    def _insert_chunked(self, slot: int, prompt: np.ndarray, n_total: int,
                        n_full: int, hits, partial_hit, keys, pkey) -> int:
        """Chunk-fold admission: reference every full-block hit (storage
        sharing), resume the fold past the hit chain (compute skipping),
        and recompute the trailing partial chunk into a block of the slot's
        own: the shared partial is never referenced, so there is no
        copy-on-write arming and nothing to disarm on rollback."""
        P = len(prompt)
        pool = self.pool
        # take references on every hit before allocating (allocation may
        # evict from the LRU the hits are parked in); on exhaustion release
        # everything this insert took so a failed admission leaks nothing
        bids: list[int] = []
        fresh: list[tuple[int, bytes | None, int]] = []  # (blk_idx, key, bid)
        try:
            bids.extend(pool.acquire(b) for b in hits)
            for j in range(len(hits), n_full):
                b = pool.alloc()
                fresh.append((j, keys[j], b))
                bids.append(b)
            if n_full * self.bs < P:                   # partial prompt block
                b = pool.alloc()
                # indexed only when no sibling indexes the chunk already;
                # private either way, since decode writes it in place
                fresh.append((n_full, None if partial_hit is not None
                              else pkey, b))
                bids.append(b)
            while len(bids) < n_total:                 # generation blocks
                bids.append(pool.alloc())
        except PoolExhausted:
            for b in bids:
                pool.release(b)
            raise

        H = self._resume_blocks(P, hits, keys)
        q0 = H * self.bs
        if H and self.tracer is not None:
            # the H prefix-hit chunks are skipped, not folded: mark the
            # resume point so the trace shows where compute was saved
            self.tracer.instant("prefix_resume",
                                args={"blocks": H, "tokens_skipped": q0,
                                      "prefix_hit": True})
        state = None
        if H and self.hybrid:
            state = self._boundary_states[keys[H - 1]]
            self._boundary_states.move_to_end(keys[H - 1])   # LRU recency
        cache, logits, snapshots = self._fold_prefill(
            prompt, q0, self._prefix_cache(bids[:H], state), keys)
        self._scatter(cache, fresh)
        # index only after the contents exist (a failed insert must never
        # leave a key pointing at an unwritten block)
        for j, key, b in fresh:
            if key is not None:
                pool.register(key, b, partial=j >= n_full)
                if j >= n_full:
                    self.partial_reg[slot] = (j, b)
        self._commit_snapshots(snapshots)
        self._set_state(slot, cache)
        return self._admitted(slot, P, bids, n_total, hits, partial_hit, q0,
                              logits)

    def _admitted(self, slot: int, P: int, bids: list[int], n_total: int,
                  hits, partial_hit, skipped: int,
                  logits: torch.Tensor) -> int:
        """The slot's table, length and statistics after a prefill; returns
        the first generated token."""
        self.tables[slot, :] = TRASH_BLOCK
        self.tables[slot, :len(bids)] = bids
        self.lens[slot] = P
        self.slot_bids[slot] = bids
        self.prefill_tokens_total += P
        self.prefill_tokens_skipped_total += skipped
        self._stats[slot] = {
            "kv_blocks": n_total,
            "prefix_hit_blocks": len(hits)
            + (1 if partial_hit is not None else 0),
            "prefill_tokens_skipped": skipped}
        self._update_peaks()
        self.last_prefill_logits = logits
        return int(logits[0].argmax())

    def _insert_oneshot(self, slot: int, prompt: np.ndarray, n_total: int,
                        n_full: int, hits, partial_hit, keys, pkey) -> int:
        """One-shot prefill: storage is shared (hit blocks are referenced,
        their recomputed values discarded) but no compute is skipped; a
        shared partial block is held read-only with lazy copy-on-write."""
        P = len(prompt)
        pool = self.pool
        # take references on every hit before allocating (allocation may
        # evict from the LRU the hits are parked in); on exhaustion release
        # everything this insert took — including the spares it armed other
        # holders with — so a failed admission leaks nothing
        bids = []
        fresh: list[tuple[int, bytes, int]] = []       # (blk_idx, key, bid)
        armed: list[tuple[int, tuple[int, int]]] = []  # (slot, partial_reg)
        try:
            bids.extend(pool.acquire(b) for b in hits)
            for j in range(len(hits), n_full):
                b = pool.alloc()
                fresh.append((j, keys[j], b))
                bids.append(b)
            if n_full * self.bs < P:                   # partial prompt block
                if partial_hit is not None:
                    # share it; every holder copies before its first write
                    self._arm_holders(partial_hit, armed)
                    pool.acquire(partial_hit)
                    bids.append(partial_hit)
                    self.cow_blk[slot] = n_full
                    self.cow_spare[slot] = pool.alloc()
                else:
                    b = pool.alloc()
                    fresh.append((n_full, pkey, b))
                    bids.append(b)
            while len(bids) < n_total:                 # generation blocks
                bids.append(pool.alloc())
        except PoolExhausted:
            for b in bids:
                pool.release(b)
            if self.cow_spare[slot] is not None:
                pool.release(self.cow_spare[slot])
            self.cow_blk[slot] = self.cow_spare[slot] = None
            self.partial_reg[slot] = None
            for s, prev in armed:                      # disarm: un-leak the
                pool.release(self.cow_spare[s])        # holders' spares
                self.cow_blk[s] = self.cow_spare[s] = None
                self.partial_reg[s] = prev
            raise

        tokens = torch.from_numpy(prompt[None]).to(self.device)
        cache, logits = engine.prefill(
            self.cfg, self.params, tokens,
            **extras_kwargs(self.cfg, self.extras, self.device))
        self._scatter(cache, fresh)
        # index only after the contents exist (a failed insert must never
        # leave a key pointing at an unwritten block)
        for j, key, b in fresh:
            pool.register(key, b, partial=j >= n_full)
            if j >= n_full:
                self.partial_reg[slot] = (j, b)
        self._set_state(slot, cache)
        return self._admitted(slot, P, bids, n_total, hits, partial_hit, 0,
                              logits)

    def _update_peaks(self) -> None:
        in_use = self.pool.blocks_in_use()
        live = sum(1 for b in self.slot_bids if b)
        saved = (live * self.max_len - in_use * self.bs) * self._token_bytes
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, in_use)
        self.peak_bytes_saved = max(self.peak_bytes_saved, saved)

    def _arm_holders(self, bid: int,
                     armed: list[tuple[int, tuple[int, int]]]) -> None:
        """Give every live holder of a newly shared partial block a spare,
        recording each in ``armed`` before the next allocation can raise so
        the caller's rollback disarms exactly these holders."""
        for s in range(self.n_slots):
            if (self.partial_reg[s] and self.partial_reg[s][1] == bid
                    and self.cow_spare[s] is None):
                prev = self.partial_reg[s]
                spare = self.pool.alloc()
                self.cow_blk[s] = prev[0]
                self.cow_spare[s] = spare
                self.partial_reg[s] = None
                armed.append((s, prev))

    def clear(self, slot: int) -> None:
        for bid in self.slot_bids[slot]:
            self.pool.release(bid)
        if self.cow_spare[slot] is not None:
            self.pool.release(self.cow_spare[slot])
        self.cow_blk[slot] = self.cow_spare[slot] = None
        self.partial_reg[slot] = None
        self.slot_bids[slot] = []
        self.tables[slot, :] = TRASH_BLOCK
        self.lens[slot] = 0

    # -- cascade grouping (backend="cascade") ------------------------------

    def _cascade_plan(self, lanes) -> list[tuple[tuple[int, ...], list]]:
        """Shared-chain groups over ``lanes``: each lane offers its full
        blocks only (every sharer holds those positions identically), and
        blocks armed for copy-on-write are skipped, so a group never reads a
        block another lane is about to rewrite."""
        skip = set()
        for s in range(self.n_slots):
            if self.cow_blk[s] is not None:
                skip.add(int(self.tables[s, self.cow_blk[s]]))
            if self.cow_spare[s] is not None:
                skip.add(int(self.cow_spare[s]))
        chains = {int(s): [int(b) for b in
                           self.tables[s, :int(self.lens[s]) // self.bs]]
                  for s in lanes}
        return self.pool.shared_chains(chains, skip=skip)

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 if n <= 1 else 1 << (n - 1).bit_length()

    def _cascade_meta(self, groups) -> dict[str, np.ndarray]:
        """The metadata of :func:`nn.attention.attend_decode_cascade` as host
        arrays (:data:`CASCADE_META`, int32 and the bool ``group_mask``),
        padded to next-pow-2 shapes as the reference pads them; ungrouped
        lanes get ``q0 = 0`` and their whole chain as the suffix."""
        G = self._pow2(len(groups))
        npre = self._pow2(max(len(c) for c, _ in groups))
        lc = self._pow2(max(len(ls) for _, ls in groups))
        gt = np.full((G, npre), TRASH_BLOCK, np.int32)
        gl = np.zeros(G, np.int32)
        lanes = np.zeros((G, lc), np.int32)
        gmask = np.zeros((G, lc), bool)
        q0b = np.zeros(self.n_slots, np.int32)         # prefix blocks
        for g, (chain, ls) in enumerate(groups):
            gt[g, :len(chain)] = chain
            gl[g] = len(chain) * self.bs
            lanes[g, :len(ls)] = ls
            gmask[g, :len(ls)] = True
            q0b[ls] = len(chain)
        # suffix tables cover [q0 blocks, the block holding the new row)
        need = [max(1, -(-(int(self.lens[s]) + 1) // self.bs) - int(q0b[s]))
                for s in range(self.n_slots)]
        nsuf = self._pow2(max(need))
        st = np.full((self.n_slots, nsuf), TRASH_BLOCK, np.int32)
        for s in range(self.n_slots):
            row = self.tables[s, q0b[s]:q0b[s] + nsuf]
            st[s, :len(row)] = row
        # per-lane keys every layer of the tick shares: the lanes' cache_len
        # (the engine's lens + 1), where each group slot's state lands, and
        # each lane's slot (its inverse; -1 for a lane in no group)
        dest = np.where(gmask, lanes, self.n_slots).reshape(-1)
        slot = np.full(self.n_slots + 1, -1, np.int32)
        slot[dest] = np.arange(dest.size, dtype=np.int32)
        return {"group_tables": gt, "group_len": gl, "group_lanes": lanes,
                "group_mask": gmask, "lane_q0": q0b * self.bs,
                "suffix_tables": st,
                "lane_lens": self.lens.astype(np.int32)[lanes] + 1,
                "group_dest": dest.astype(np.int32),
                "lane_slot": slot[:self.n_slots]}

    def cascade_stats(self) -> dict:
        """The groups the next tick would form over the live lanes, and the
        prefix rows each layer attends once per group against once per lane
        (``prefix_rows`` vs ``prefix_rows_flat``)."""
        lanes = [s for s in range(self.n_slots)
                 if self.slot_bids[s] and not self.at_capacity(s)]
        shapes = [(len(c), len(ls)) for c, ls in self._cascade_plan(lanes)]
        return {
            "groups": len(shapes),
            "grouped_lanes": sum(n for _, n in shapes),
            "prefix_rows": sum(c * self.bs for c, _ in shapes),
            "prefix_rows_flat": sum(c * self.bs * n for c, n in shapes),
        }

    def tick_bytes_proxy(self) -> dict:
        """Arena bytes one tick moves under each dataflow, from the shapes
        (a model, not a measurement): ``gather`` reads every lane's whole
        table into a dense cache, rewrites it and scatters one block back;
        ``inplace`` reads the blocks live chains own and writes one row per
        lane; ``cascade`` reads each shared chain once per group instead of
        once per lane."""
        token = self._token_bytes
        n, ml, bs = self.n_slots, self.max_len, self.bs
        gather = n * ml * token * 2 + n * bs * token
        live_rows = sum(-(-(int(ln) + 1) // bs) * bs
                        for ln, b in zip(self.lens, self.slot_bids) if b)
        inplace = live_rows * token + n * token
        groups = self._cascade_plan(
            [s for s in range(n) if self.slot_bids[s]])
        q0b = {s: len(c) for c, ls in groups for s in ls}
        prefix_rows = sum(len(c) * bs for c, _ in groups)
        suffix_rows = sum((-(-(int(ln) + 1) // bs) - q0b.get(s, 0)) * bs
                          for s, (ln, b) in
                          enumerate(zip(self.lens, self.slot_bids)) if b)
        cascade = (prefix_rows + suffix_rows) * token + n * token
        return {"gather": gather, "inplace": inplace, "cascade": cascade}

    # -- decode --------------------------------------------------------------

    def at_capacity(self, slot: int) -> bool:
        """A slot whose context has filled every block cannot take another
        token: its next write has no block to land in."""
        return bool(self.slot_bids[slot]) and \
            int(self.lens[slot]) >= self.max_len

    def _tick_inputs(self, tokens: np.ndarray, active: np.ndarray
                     ) -> tuple[capture.CapturedStep, tuple, np.ndarray]:
        """The host side of a tick: copy-on-write and write targets, then
        (cascade) the grouping.  Returns the captured step the tick runs,
        its host inputs and the lanes that write."""
        active = np.asarray(active, bool).copy()
        wbids = np.full(self.n_slots, TRASH_BLOCK, np.int32)
        for slot in np.nonzero(active)[0]:
            if self.at_capacity(slot):
                # a full slot must not write: route the lane to the trash
                # block and keep its length frozen
                active[slot] = False
                continue
            blk = int(self.lens[slot]) // self.bs
            bid = int(self.tables[slot, blk])
            if self.cow_blk[slot] is not None and blk == self.cow_blk[slot]:
                spare = self.cow_spare[slot]
                self._copy(spare, bid)
                self.pool.cow_copies += 1
                self.pool.release(bid)
                self.tables[slot, blk] = spare
                self.slot_bids[slot][blk] = spare
                self.cow_blk[slot] = self.cow_spare[slot] = None
                bid = spare
            elif self.pool.is_partial(bid):
                # sole owner writes in place: the cached chunk changes, so
                # the index entry must go before the write lands
                self.pool.drop_partial(bid)
                self.partial_reg[slot] = None
            wbids[slot] = bid
        step = self._decode
        inputs = (np.asarray(tokens, np.int32)[:, None], self.tables,
                  self.lens.astype(np.int32), wbids)
        if self.hybrid:
            # the lanes whose recurrent state the tick advances: the
            # active ones, an at-capacity lane frozen above, as in the
            # reference
            inputs += (active,)
        if self.backend == "cascade":
            # grouping runs after the copy-on-write and write-target loop,
            # so a block resolved this tick is never both read by a group
            # pass and rewritten by its owner
            groups = self._cascade_plan(np.nonzero(active)[0])
            self.last_groups = len(groups)
            if groups:
                meta = self._cascade_meta(groups)
                step = self._decode_cascade
                inputs += tuple(meta[key] for key in CASCADE_META)
        return step, inputs, active

    def decode(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One tick over every lane; returns the greedy token per lane
        (garbage for inactive lanes, whose lengths stay as they are).
        ``last_logits`` is this tick's (n_slots, vocab_padded) float32
        logits, a copy that later ticks leave as it is."""
        step, inputs, active = self._tick_inputs(tokens, active)
        logits = step(*inputs)
        self.lens[active] += 1
        # the step's output is overwritten by its next replay
        self.last_logits = logits.clone()
        return self.last_logits.argmax(-1).cpu().numpy()

    def cost_args(self) -> dict[str, tuple]:
        """The serving stages with their analytic counts, for
        ``obs.costmodel`` roofline attribution: ``(count, args)``, where
        ``count(*args)`` gives a stage's FLOPs and bytes per call, at the
        reference's representative calls: the decode tick of every lane
        over a full table, one cold block-size chunk of the fold, a
        one-block prefill and the copy-on-write block copy."""
        cfg, n = self.cfg, self.n_slots
        block = costmodel.lm_stage(cfg, costmodel.prompt_work(cfg, 0, self.bs))
        return {"prefill": block, "chunk_fold": block,
                "decode": costmodel.lm_stage(cfg, costmodel.tick_work(
                    cfg, n, [self.max_len] * n)),
                "copy": (costmodel.block_copy_cost, (cfg, self.bs))}

    def jit_fns(self) -> dict[str, capture.CapturedStep]:
        """Named captured steps, for ``obs.RecompileDetector.track``: the
        reference's ``decode`` and, under cascade, ``decode_cascade``.  The
        reference's other entry points run eagerly here or inside the
        cascade tick's graph (its ``cascade_prefix``, ``cascade_suffix`` and
        ``cascade_merge`` jits), and are not counted on their own
        (:data:`NOT_CAPTURED`)."""
        fns = {"decode": self._decode}
        if self.backend == "cascade":
            fns["decode_cascade"] = self._decode_cascade
        return fns

    # -- telemetry -----------------------------------------------------------

    def arena_block(self, key: str, bid: int) -> torch.Tensor:
        """One arena block's contents for ``key``: the B=1 cache slice of
        ``block_size`` positions."""
        return self.arena[key].select(engine.arena_block_axis(
            self.arena[key]), bid)

    def slot_stats(self, slot: int) -> dict:
        return dict(self._stats[slot])

    def pool_stats(self) -> dict:
        st = self.pool.stats()
        live = sum(1 for b in self.slot_bids if b)
        st["bytes_dense_equiv"] = live * self.max_len * self._token_bytes
        st["bytes_paged"] = st["blocks_in_use"] * self.bs * self._token_bytes
        st["bytes_saved_vs_dense"] = (st["bytes_dense_equiv"]
                                      - st["bytes_paged"])
        st["peak_blocks_in_use"] = self.peak_blocks_in_use
        st["peak_bytes_saved_vs_dense"] = self.peak_bytes_saved
        st["prefill_tokens_total"] = self.prefill_tokens_total
        st["prefill_tokens_skipped"] = self.prefill_tokens_skipped_total
        st["boundary_state_bytes"] = sum(
            a.numel() * a.element_size()
            for state in self._boundary_states.values()
            for a in state.values())
        return st
