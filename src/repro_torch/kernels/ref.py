"""Plain PyTorch versions of the CUDA kernels, with the kernels' signatures.

They run on the CPU (the wrappers use them for CPU tensors) and on the card
(``chip_smoke.py`` holds each kernel bitwise against them there).  Packed
words are ``torch.int32`` tensors holding uint32 bit patterns; the bit
arithmetic runs in int64 on the masked patterns, because PyTorch has no
``>>``, ``-`` or ``<`` for ``torch.uint32`` on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import arith
from repro_torch.core.bitstream import WORD, n_words

_U32 = 0xFFFFFFFF
# elements of the (rows, K, O, Wd) AND product materialized at once
_CHUNK_ELEMS = 1 << 24


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR in int64) -> int64."""
    v = v.to(torch.int64) & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """Comparator SNG + LSB-first packing.

    levels: any shape, int32 in [0, N]; codes: (N,) int32.  Returns
    (..., n_words(N)) int32: bit t of word w is ``codes[32w+t] < level``;
    for N < 32 the bits above N are 0.
    """
    nw = n_words(length)
    bits = (codes[None, :length] < levels.reshape(-1, 1)).to(torch.int64)
    pad = nw * WORD - length
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[0], pad)], dim=1)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD, dtype=torch.int64, device=bits.device)
    packed = (bits.reshape(-1, nw, WORD) * weights).sum(-1)
    return to_int32_bits(packed).reshape(levels.shape + (nw,))


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
           s0_mode: str = "alt", adder: str = "tff") -> torch.Tensor:
    """AND + popcount over the words, then the TFF tree over K.

    x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32.
    Returns (M, O) int32 root counts.  K is padded to a power of two with
    zero leaves; ``adder="ideal"`` returns ``sum >> depth`` instead.
    """
    M, K, Wd = x_packed.shape
    O = w_packed.shape[1]
    rows = max(1, _CHUNK_ELEMS // max(1, K * O * Wd))
    counts = torch.cat([                                  # (M, K, O)
        popcount32(x_packed[i:i + rows, :, None, :] & w_packed[None]).sum(-1)
        for i in range(0, M, rows)])
    if adder == "ideal":
        return (counts.sum(1) >> arith.tree_depth(K)).to(torch.int32)
    if adder != "tff":
        raise ValueError(f"unknown adder {adder!r}")
    return arith.tff_tree_counts(counts.transpose(1, 2), s0_mode
                                 ).to(torch.int32)


# --------------------------------------------------------------------------
# Paged KV cache: decode attention through a block table, and the tick's
# in-place row write.
# --------------------------------------------------------------------------

NEG_INF = -1e30
NO_WINDOW = 1 << 30          # a window this large never masks


def splice_rows(kv: torch.Tensor, rows: torch.Tensor, at: torch.Tensor
                ) -> torch.Tensor:
    """In place: write ``rows[b]`` at position ``at[b]`` of ``kv[b]``
    (B, S, H, D), dropping lanes whose position falls outside ``[0, S)`` —
    an at-capacity lane rides the decode tick masked, with ``at == S``."""
    ok = ((at >= 0) & (at < kv.shape[1]))[:, None, None]
    lanes = torch.arange(kv.shape[0], device=kv.device)
    at = at.long().clamp(0, kv.shape[1] - 1)
    kv[lanes, at] = torch.where(ok, rows.to(kv.dtype), kv[lanes, at])
    return kv


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, tables: torch.Tensor,
                           lens: torch.Tensor, window: int | None = None,
                           new_kv: tuple[torch.Tensor, torch.Tensor] | None
                           = None) -> torch.Tensor:
    """One-query decode attention read through a block table.

    q: (B, Hq, D); k_arena, v_arena: (num_blocks, bs, Hkv, D); tables:
    (B, nb) block ids; lens: (B,) valid lengths.  Position ``pos`` of lane
    ``b`` attends when ``lens[b] - win <= pos < lens[b]`` (``win`` is
    ``NO_WINDOW`` for a window of None or 0).  ``new_kv`` = (k1, v1), each
    (B, Hkv, D), replaces the row at ``lens[b] - 1`` (dropped past the
    table's end).  Scores, softmax and the value product are float32 —
    the probabilities are not cast to the arena's dtype — and the result is
    divided by ``max(l, 1e-30)``, as the TPU kernel does.  Returns
    (B, Hq, D) in v_arena's dtype; a lane with ``lens == 0`` is garbage."""
    B, Hq, D = q.shape
    Hkv = k_arena.shape[2]
    win = window if window else NO_WINDOW
    t = tables.long()
    k = k_arena[t].reshape(B, -1, Hkv, D).float()         # (B, S, Hkv, D)
    v = v_arena[t].reshape(B, -1, Hkv, D).float()
    S = k.shape[1]
    if new_kv is not None:
        splice_rows(k, new_kv[0], lens - 1)
        splice_rows(v, new_kv[1], lens - 1)
    qh = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bhrs", qh, k) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    ln = lens.long()[:, None, None, None]
    s = torch.where((pos < ln) & (pos >= ln - win), s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhrs,bshd->bhrd", p, v)
    out = out / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(v_arena.dtype)


def scatter_kv_rows(k_arena: torch.Tensor, v_arena: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor,
                    wbids: torch.Tensor, offs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """In place: ``arena[l, wbids[b], 0, offs[b]] = rows[l, b]`` for both
    arenas (L, num_blocks, 1, bs, Hkv, D), rows (L, S, Hkv, D).  No other
    row changes; lanes that collide (only trash-routed ones may) land in
    some order.  Returns the two arenas."""
    w, o = wbids.long(), offs.long()
    k_arena[:, w, 0, o] = k_rows.to(k_arena.dtype)
    v_arena[:, w, 0, o] = v_rows.to(v_arena.dtype)
    return k_arena, v_arena
