"""Attention: chunked online-softmax prefill, dense single-token decode (a
length per lane) and paged single-token decode, flat or cascaded over
shared prefixes.

``attend_chunked`` is the reference's flash-style prefill and training
attention (float32 online softmax) through the ``flash_attention`` kernel,
or its plain version on CPU tensors; when an input requires grad it runs
as :class:`FlashAttention`, whose backward is the reference's FA2 backward
(``flash_attention_bwd``).
``attend_decode_paged`` reads K/V through a block table: its ``"plain"``
backend gathers each lane's chain and applies the masked softmax (the
reference's ``"xla"`` body); its ``"cuda"`` backend calls the
``paged_decode_attention`` kernel, which reads the blocks in place; its
``"cascade"`` backend is :func:`attend_decode_cascade`.

Over a slice's ``"model"`` axis (sharded serving): a tick's attention runs
once per arena shard (:func:`attend_decode_shards`), and a prompt's, inside
:func:`over_head_shards`, once per KV-head range; each shard takes the
query heads of its KV heads (GQA groups stay whole) and the outputs are
joined in head order on the queries' device.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.kernels import paged_attn as paged_kernels
from repro_torch.kernels.ref import (NEG_INF,  # noqa: F401
                                     merge_softmax_states, splice_rows)
from repro_torch.serve import kvquant


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, Hq, D) in
    v's dtype.

    Scores, the running max and sum, and the accumulator are float32; the
    probabilities are cast to v's dtype before the value product, as in the
    reference.  ``window`` > 0 masks keys more than ``window - 1`` positions
    behind the query; ``q_offset`` is the absolute position of q[:, 0].
    CUDA tensors run the ``flash_attention`` kernel (its own tiles); CPU
    tensors run its plain version in ``q_chunk`` x ``kv_chunk`` chunks.

    When grad is enabled and q, k or v requires it, the call goes through
    :class:`FlashAttention` (the same forward, which also keeps the rows'
    log-sum-exp); otherwise it is the plain forward call, so serving and
    captured steps are unchanged."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    q_chunk, kv_chunk)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    if _HEAD_SHARDS is None:
        return flash_kernels.flash_attention(q, k, v, **kw)
    rep = q.shape[2] // k.shape[2]
    outs = []
    for dev, (h0, h1) in _HEAD_SHARDS:
        qd, kd, vd = (t[:, :, a:b].contiguous().to(dev) for t, a, b in
                      ((q, h0 * rep, h1 * rep), (k, h0, h1), (v, h0, h1)))
        outs.append(flash_kernels.flash_attention(qd, kd, vd, **kw)
                    .to(q.device))
    return torch.cat(outs, dim=2)


# the KV-head ranges prompt attention splits over, with their devices
# (:func:`over_head_shards`); None: one call over every head
_HEAD_SHARDS: list | None = None


@contextlib.contextmanager
def over_head_shards(groups):
    """Within the block, :func:`attend_chunked` runs once per ``(device,
    (lo, hi))`` of ``groups``: KV heads [lo, hi) and their query heads on
    ``device``, the outputs joined in head order on the queries' device
    (a prefill or fold chunk of a slice whose arena splits KV heads over
    its devices).  None: one call, as outside the block.  Training calls
    (inputs that require grad) are not split."""
    global _HEAD_SHARDS
    prev, _HEAD_SHARDS = _HEAD_SHARDS, groups
    try:
        yield
    finally:
        _HEAD_SHARDS = prev


class FlashAttention(torch.autograd.Function):
    """``attend_chunked`` with a gradient: the reference's ``_flash``
    custom VJP.  The forward runs ``flash_attention`` with
    ``return_lse`` and saves (q, k, v, out, lse); the backward runs
    ``flash_attention_bwd`` (the kernel on CUDA tensors, its plain version
    on CPU tensors), which recomputes the probabilities from (q, k, lse)
    instead of storing them.  dk and dv of GQA sum each group's query
    heads.  Causal, windowed, offset and non-causal (cross-attention over
    a fixed key range) calls are covered alike; the reference's sliding
    layers (``_sliding``) compute the same function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        out, lse = flash_kernels.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_kernels.flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int | torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """One-token decode attention against a dense cache.

    q: (B, 1, Hq, D); k_cache, v_cache: (B, Smax, Hkv, D); ``cache_len``
    the valid positions, one for every lane (an int or a 0-d tensor) or a
    (B,) tensor of each lane's, with the new token's K/V already written
    at ``cache_len - 1``.  The operations are the plain paged read's
    (:func:`attend_decode_paged`), so a cache that holds a lane's chain
    gives its bits."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qh = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bhrs", qh, k_cache.float()) * D ** -0.5
    pos = torch.arange(Smax, device=q.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim():
        cache_len = cache_len.long()[:, None, None, None]
    valid = pos < cache_len
    if window:
        valid &= pos >= cache_len - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(v_cache.dtype)


def gather_paged_kv(arena: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """arena: (num_blocks, bs, Hkv, D); block_table: (B, nb) integer.
    Returns the dense (B, nb*bs, Hkv, D) view of each row's chain; entries
    past a chain point at the trash block, masked downstream."""
    g = arena[block_table.long()]                   # (B, nb, bs, Hkv, D)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def attend_decode_paged(q: torch.Tensor, k_arena: torch.Tensor,
                        v_arena: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor, *, window: int = 0,
                        new_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                        backend: str = "plain",
                        cascade: dict | None = None,
                        scales: tuple[torch.Tensor, torch.Tensor] | None
                        = None,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One-token decode attention against a paged cache (one layer).

    q: (B, 1, Hq, D); k_arena, v_arena: (num_blocks, bs, Hkv, D);
    block_table: (B, nb) int32; cache_len: (B,) int32 valid lengths.
    ``new_kv``: optional (k1, v1), each (B, Hkv, D), the current token's row,
    read at ``cache_len - 1`` in place of the arena's.

    ``backend="plain"`` gathers and applies the masked softmax (the
    reference's ``"xla"`` body; probabilities cast to v's dtype before the
    value product); ``"cuda"`` runs the ``paged_decode_attention`` kernel
    (no gather, no cast of the probabilities); ``"cascade"`` runs
    :func:`attend_decode_cascade` with the group metadata ``cascade`` (the
    block table is then unused).  Returns (B, 1, Hq, D) in v_arena's
    dtype.

    ``scales``: (k_scale_arena, v_scale_arena), each (num_blocks, bs, Hkv,
    1) float32, the int8 ``kv_quant`` layout (plain backend only): the
    scales are gathered beside K/V and the gathered view dequantized to
    ``out_dtype`` (elementwise, so bitwise dequantizing the dense cache and
    gathering it); ``new_kv`` then carries the dequantized row, and the
    result is in ``out_dtype``."""
    if scales is not None and backend != "plain":
        raise ValueError(f"backend={backend!r} does not cover the int8 "
                         "kv_quant layout")
    if backend == "cuda":
        return paged_kernels.paged_decode_attention(
            q[:, 0], k_arena, v_arena, block_table, cache_len,
            window=window, new_kv=new_kv)[:, None]
    if backend == "cascade":
        if cascade is None:
            raise ValueError('backend="cascade" needs the group metadata '
                             "in cascade=")
        return attend_decode_cascade(q, k_arena, v_arena, cascade, cache_len,
                                     window=window, new_kv=new_kv)
    if backend != "plain":
        raise ValueError(f"unknown attention backend {backend!r}")
    k = gather_paged_kv(k_arena, block_table)        # (B, S, Hkv, D)
    v = gather_paged_kv(v_arena, block_table)
    if scales is not None:
        k = kvquant.dequantize(k, gather_paged_kv(scales[0], block_table),
                               out_dtype)
        v = kvquant.dequantize(v, gather_paged_kv(scales[1], block_table),
                               out_dtype)
    return _read_gathered(q, k, v, cache_len, window, new_kv)


def _read_gathered(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache_len: torch.Tensor, window: int,
                   new_kv: tuple[torch.Tensor, torch.Tensor] | None
                   ) -> torch.Tensor:
    """The plain paged read's masked softmax over gathered chains k, v
    (B, S, Hkv, D), ``new_kv`` spliced in at ``cache_len - 1``."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    if new_kv is not None:
        k = splice_rows(k, new_kv[0], cache_len - 1)
        v = splice_rows(v, new_kv[1], cache_len - 1)
    qh = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bhrs", qh, k.float()) * D ** -0.5
    pos = torch.arange(k.shape[1], device=q.device)
    lens = cache_len.long()[:, None, None, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, Hq, D).to(v.dtype)


@dataclasses.dataclass
class KVShard:
    """One layer of one arena shard (``serve.engine.ArenaShard``): k, v
    (num_blocks, bs_d, Hkv_d, D), the int8 layout's (k_scale, v_scale)
    alike or None, the shard's device, and the KV heads and in-block
    positions [lo, hi) of the whole arena's that it holds."""
    k: torch.Tensor
    v: torch.Tensor
    scales: tuple | None
    device: torch.device
    heads: tuple[int, int]
    positions: tuple[int, int]


def attend_decode_shards(q: torch.Tensor, shards: list[KVShard],
                         block_table: torch.Tensor, cache_len: torch.Tensor,
                         *, window: int = 0,
                         new_kv: tuple[torch.Tensor, torch.Tensor] | None
                         = None, backend: str = "plain",
                         cascade: dict | None = None,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """:func:`attend_decode_paged` over an arena split across a slice's
    devices.  Operands as there (``q`` (B, 1, Hq, D) and ``new_kv`` with
    every head, on the first shard's device), the arena as ``shards``.
    Returns (B, 1, Hq, D) on ``q``'s device, in the arena's dtype (the
    int8 layout: ``out_dtype``).

    KV heads split: each shard's read runs on its device with its KV
    heads' query heads (GQA groups stay whole) and its heads of
    ``new_kv``, through ``backend`` as :func:`attend_decode_paged` runs it,
    and the outputs are joined in head order.

    The split-KV fallback (each shard holds every head at part of each
    block's positions): ``"plain"`` gathers each lane's chain from the
    shards, joins the positions back in order and reads it as the
    unsharded plain read does; ``"cuda"`` and ``"cascade"`` sweep each
    shard's rows through ``paged_decode_attention_with_state`` (``q0`` the
    shard's first in-block position, ``block_stride`` the block size, so
    the window and the new row at ``cache_len - 1`` fall where they
    belong) and merge the shards' float32 states in order
    (``merge_attn_states``; over more than two shards
    ``merge_attn_states_n``).  The cascade's group passes take contiguous
    blocks, so under the fallback its tick reads each lane's whole chain
    as the flat one does."""
    dev0 = q.device
    B, _, Hq, D = q.shape
    Hkv = sum(h1 - h0 for h0, h1 in {sh.heads for sh in shards})
    rep = Hq // Hkv
    if shards[0].positions == shards[-1].positions:          # KV heads
        outs = []
        for sh in shards:
            (h0, h1), dev = sh.heads, sh.device
            qd = q[:, :, h0 * rep:h1 * rep].contiguous().to(dev)
            nd = None if new_kv is None else tuple(
                t[:, h0:h1].contiguous().to(dev) for t in new_kv)
            meta = None if cascade is None else {
                key: t.to(dev) for key, t in cascade.items()}
            o = attend_decode_paged(qd, sh.k, sh.v, block_table.to(dev),
                                    cache_len.to(dev), window=window,
                                    new_kv=nd, backend=backend,
                                    cascade=meta, scales=sh.scales,
                                    out_dtype=out_dtype)
            outs.append(o.to(dev0))
        return torch.cat(outs, dim=2)
    if backend == "plain":
        def chains(get) -> torch.Tensor:
            g = torch.cat([get(sh)[block_table.to(sh.device).long()].to(dev0)
                           for sh in shards], dim=2)    # (B, nb, bs, H, D)
            return g.reshape(B, -1, *g.shape[3:])
        k, v = chains(lambda sh: sh.k), chains(lambda sh: sh.v)
        if shards[0].scales is not None:
            k = kvquant.dequantize(k, chains(lambda sh: sh.scales[0]),
                                   out_dtype)
            v = kvquant.dequantize(v, chains(lambda sh: sh.scales[1]),
                                   out_dtype)
        return _read_gathered(q, k, v, cache_len, window, new_kv)
    if shards[0].scales is not None:
        raise ValueError(f"backend={backend!r} does not cover the int8 "
                         "kv_quant layout")
    bs = shards[-1].positions[1]
    states = []
    for sh in shards:
        dev = sh.device
        q0 = torch.full((B,), sh.positions[0], dtype=torch.int32, device=dev)
        st = paged_kernels.paged_decode_attention_with_state(
            q[:, 0].contiguous().to(dev), sh.k, sh.v, block_table.to(dev),
            cache_len.to(dev), window=window, q0=q0,
            new_kv=None if new_kv is None else tuple(t.to(dev)
                                                     for t in new_kv),
            block_stride=bs)
        states.append(tuple(t.to(dev0) for t in st))
    out = paged_kernels.merge_attn_states(*states[0], *states[1]) \
        if len(states) == 2 else paged_kernels.merge_attn_states_n(
            *(torch.stack(ts) for ts in zip(*states)))
    return out.to(shards[0].v.dtype)[:, None]


def attend_decode_cascade(q: torch.Tensor, k_arena: torch.Tensor,
                          v_arena: torch.Tensor, cascade: dict,
                          cache_len: torch.Tensor, *, window: int = 0,
                          new_kv: tuple[torch.Tensor, torch.Tensor] | None
                          = None) -> torch.Tensor:
    """Two-level decode attention over shared radix prefixes (one layer).

    Lanes that share an indexed prefix chain attend it once as a group: one
    multi-query pass over the chain (``cascade_prefix_attention``), then one
    pass per lane over its divergent suffix from the absolute offset
    ``lane_q0`` (``paged_decode_attention_with_state``) whose epilogue
    merges the lane's prefix state into its own float32 state by
    log-sum-exp and normalizes (``merge_attn_states``, fused: bit for bit
    the state, :func:`place_group_states`, the merge and the cast).  Both
    run as the CUDA kernels on CUDA tensors and as their plain versions on
    CPU tensors.  ``cascade`` holds the host-built metadata (pow2-padded
    shapes):

      group_tables  (G, npre)  int32  chain block ids, trash-padded
      group_len     (G,)       int32  chain tokens (0 for a padded group)
      group_lanes   (G, Lc)    int32  lane ids per group, 0-padded
      group_mask    (G, Lc)    bool   which lane slots are real
      lane_q0       (B,)       int32  prefix tokens per lane (0: ungrouped)
      suffix_tables (B, nsuf)  int32  per-lane suffix block ids
      lane_lens     (G, Lc)    int32  cache_len[group_lanes]
      group_dest    (G*Lc,)    int32  each slot's lane, B for a padded slot
      lane_slot     (B,)       int32  each lane's slot g*Lc + c, -1 if none

The last three are the same in every layer of a tick, so the adapter builds
them on the host with the rest (:func:`with_lane_meta` derives them from
the first six on the device).
    Positions ``[0, lane_q0)`` come from the group pass and ``[lane_q0,
    cache_len)`` from the suffix pass, with the same ``cache_len`` and
    ``window`` bounds as :func:`attend_decode_paged`.  The flat path
    normalizes inside one sweep and this one after the merge, so the two
    agree to float32 rounding, not bit for bit.  Returns (B, 1, Hq, D) in
    v_arena's dtype."""
    q1 = q[:, 0]
    prefix = paged_kernels.cascade_prefix_attention(
        q1[cascade["group_lanes"]], k_arena, v_arena,
        cascade["group_tables"], cascade["group_len"], cascade["lane_lens"],
        window=window)
    return paged_kernels.paged_decode_attention_with_state(
        q1.contiguous(), k_arena, v_arena, cascade["suffix_tables"],
        cache_len, window=window, q0=cascade["lane_q0"], new_kv=new_kv,
        prefix=prefix + (cascade["lane_slot"],))[:, None]


def place_group_states(cascade: dict, acc: torch.Tensor, m: torch.Tensor,
                       l: torch.Tensor, B: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The group pass's states (acc (G, Lc, Hq, D), m and l (G, Lc, Hq)) on
    their lanes: (B, Hq, D), (B, Hq), (B, Hq).  Real slots name distinct
    lanes, so this is a plain indexed copy; padded slots go to a spare row
    that is dropped, and a lane in no group keeps the empty state.  The
    tick does not run it (its merge reads the group layout through
    ``lane_slot``); it builds the unfused composition that checks hold the
    fused merge against."""
    G, Lc, Hq, D = acc.shape
    dest = cascade["group_dest"]
    acc1 = acc.new_zeros((B + 1, Hq, D))
    m1 = m.new_full((B + 1, Hq), NEG_INF)
    l1 = l.new_zeros((B + 1, Hq))
    acc1[dest] = acc.reshape(G * Lc, Hq, D)
    m1[dest] = m.reshape(G * Lc, Hq)
    l1[dest] = l.reshape(G * Lc, Hq)
    return acc1[:B], m1[:B], l1[:B]


def with_lane_meta(cascade: dict, cache_len: torch.Tensor) -> dict:
    """``cascade`` with ``lane_lens``, ``group_dest`` and ``lane_slot``
    added, computed on the device from the six keys the reference's
    metadata holds."""
    B = cache_len.shape[0]
    lanes = cascade["group_lanes"].long()
    dest = torch.where(cascade["group_mask"], lanes, B).reshape(-1)
    slot = torch.full((B + 1,), -1, dtype=torch.int32, device=dest.device)
    slot[dest] = torch.arange(dest.numel(), dtype=torch.int32,
                              device=dest.device)
    return {**cascade, "lane_lens": cache_len[lanes].to(torch.int32),
            "group_dest": dest.to(torch.int32), "lane_slot": slot[:B]}
