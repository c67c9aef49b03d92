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
"""
from __future__ import annotations

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
    return flash_kernels.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        q_chunk=q_chunk, kv_chunk=kv_chunk)


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
    B, _, Hq, D = q.shape
    Hkv = k_arena.shape[2]
    k = gather_paged_kv(k_arena, block_table)        # (B, S, Hkv, D)
    v = gather_paged_kv(v_arena, block_table)
    if scales is not None:
        k = kvquant.dequantize(k, gather_paged_kv(scales[0], block_table),
                               out_dtype)
        v = kvquant.dequantize(v, gather_paged_kv(scales[1], block_table),
                               out_dtype)
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
