"""Plain PyTorch versions of the CUDA kernels, with the kernels' signatures.

They run on the CPU (the wrappers use them for CPU tensors) and on the card
(``chip_smoke.py`` holds each kernel bitwise against them there).  Packed
words are ``torch.int32`` tensors holding uint32 bit patterns, because
PyTorch has no ``>>``, ``-`` or ``<`` for ``torch.uint32`` on the CPU: the
bit arithmetic masks after every (arithmetic) right shift.
"""
from __future__ import annotations

import torch

from repro_torch.core import arith
from repro_torch.core.bitstream import encode_comparator

# elements of the (rows, K, O, Wd) AND product materialized at once, by
# device type: on the CPU a chunk of 8 MB, whose buffers the allocator
# reuses pass after pass instead of mapping fresh pages for each
_CHUNK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 21}


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns -> int32.  SWAR in int32:
    each right shift is masked, so the sign's copies drop out, and the
    last product wraps with the count in its top byte (at most 32).  The
    first step makes a new tensor, which the rest updates in place."""
    v = v.to(torch.int32)
    v = v - ((v >> 1) & 0x55555555)
    t = (v >> 2) & 0x33333333
    v &= 0x33333333
    v += t
    v += v >> 4
    v &= 0x0F0F0F0F
    v *= 0x01010101
    v >>= 24
    return v


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """Comparator SNG + LSB-first packing.

    levels: any shape, int32 in [0, N]; codes: (N,) int32.  Returns
    (..., n_words(N)) int32: bit t of word w is ``codes[32w+t] < level``;
    for N < 32 the bits above N are 0.
    """
    return encode_comparator(levels, codes[:length], length)


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
           s0_mode: str = "alt", adder: str = "tff") -> torch.Tensor:
    """AND + popcount over the words, then the TFF tree over K.

    x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32.
    Returns (M, O) int32 root counts.  K is padded to a power of two with
    zero leaves; ``adder="ideal"`` returns ``sum >> depth`` instead.  Rows
    of X go through in chunks, each reduced to its roots before the next,
    so no (M, K, O) tensor of counts is held.
    """
    if adder not in ("tff", "ideal"):
        raise ValueError(f"unknown adder {adder!r}")
    M, K, Wd = x_packed.shape
    O = w_packed.shape[1]
    rows = max(1, _CHUNK_ELEMS[x_packed.device.type] // max(1, K * O * Wd))

    def roots(x: torch.Tensor) -> torch.Tensor:          # (rows, O)
        counts = popcount32(x[:, :, None, :] & w_packed[None]).sum(
            -1, dtype=torch.int32)                        # (rows, K, O)
        if adder == "ideal":
            return counts.sum(1, dtype=torch.int32) >> arith.tree_depth(K)
        return arith.tff_tree_counts(counts.transpose(1, 2), s0_mode)
    return torch.cat([roots(x_packed[i:i + rows])
                      for i in range(0, M, rows)])


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


def scatter_kv_rows(k_arena: torch.Tensor, v_arena: torch.Tensor, k_rows,
                    v_rows, wbids: torch.Tensor, offs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """In place: ``arena[l, wbids[b], 0, offs[b]] = rows[l][b]`` for both
    arenas (L, num_blocks, 1, bs, Hkv, D), rows stacked (L, S, Hkv, D) or
    a sequence of L tensors (S, Hkv, D).  No other row changes; lanes that
    collide (only trash-routed ones may) land in some order.  The int8
    layout's tick writes its int8 rows and, in a second call, its float32
    scale rows (D = 1) through it.  Returns the two arenas."""
    if not isinstance(k_rows, torch.Tensor):
        k_rows, v_rows = torch.stack(list(k_rows)), torch.stack(list(v_rows))
    w, o = wbids.long(), offs.long()
    k_arena[:, w, 0, o] = k_rows.to(k_arena.dtype)
    v_arena[:, w, 0, o] = v_rows.to(v_arena.dtype)
    return k_arena, v_arena


# --------------------------------------------------------------------------
# Cascade decode: a lane's attention split into a shared-prefix pass per
# group and a divergent-suffix pass per lane, each returning its unnormalized
# float32 online-softmax state (acc, m, l), and their log-sum-exp merge.
# --------------------------------------------------------------------------

def softmax_state(s: torch.Tensor, valid: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked softmax state of float32 scores ``s`` (..., S) under the bool
    mask ``valid`` (broadcast to ``s``).  Returns (p, m, l): the
    unnormalized probabilities, zero where invalid, so a fully masked row
    gives the empty state m = NEG_INF, l = 0 rather than a uniform one."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid
    return p, m, p.sum(-1)


def merge_softmax_states(acc1, m1, l1, acc2, m2, l2):
    """Log-sum-exp merge of two online-softmax states over disjoint key
    sets (acc with a trailing feature axis, m and l without).  Returns the
    merged (acc, m, l).  An empty side (m = NEG_INF, l = 0, acc = 0) drops
    out exactly, and two empty sides give zeros: NEG_INF is finite."""
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return (c1[..., None] * acc1 + c2[..., None] * acc2, m,
            c1 * l1 + c2 * l2)


def paged_decode_attention_with_state(
        q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
        tables: torch.Tensor, lens: torch.Tensor, window: int | None = None,
        q0: torch.Tensor | None = None,
        new_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        block_stride: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flat sweep restarted at the absolute offset ``q0`` and left
    unnormalized.

    Same operands as :func:`paged_decode_attention`; ``tables`` (B, nsuf)
    names each lane's blocks of ``bs`` rows, entry j holding positions
    ``q0[b] + j*stride + i`` for i < bs (``q0`` None: 0; ``block_stride``
    None: stride = bs, contiguous blocks).  A stride past bs is a shard of
    the split-KV fallback, which holds bs positions of each stride-position
    block.  Position ``pos`` attends when ``lens[b] - win <= pos <
    lens[b]``; ``new_kv`` replaces the row at ``lens[b] - 1``, dropped
    where no row of the table holds that position.  Returns the float32
    state (acc (B, Hq, D), m (B, Hq), l (B, Hq)); an all-masked sweep gives
    the empty state.  Masked rows never reach acc, so garbage in the trash
    block cannot either."""
    B, Hq, D = q.shape
    bs, Hkv = k_arena.shape[1], k_arena.shape[2]
    stride = block_stride or bs
    win = window if window else NO_WINDOW
    t = tables.long()
    k = k_arena[t].reshape(B, -1, Hkv, D).float()         # (B, S, Hkv, D)
    v = v_arena[t].reshape(B, -1, Hkv, D).float()
    start = torch.zeros_like(lens) if q0 is None else q0
    if new_kv is not None:
        # the new row's local index: entry r // stride, row r % stride,
        # dropped (-1) where the row falls past the entry's bs rows
        r = (lens - 1 - start).long()
        j, i = r.div(stride, rounding_mode="floor"), r.remainder(stride)
        at = torch.where(i < bs, j * bs + i, -1)
        splice_rows(k, new_kv[0], at)
        splice_rows(v, new_kv[1], at)
    local = (torch.arange(t.shape[1], device=q.device)[:, None] * stride
             + torch.arange(bs, device=q.device)).reshape(-1)
    pos = start.long()[:, None] + local
    ln = lens.long()[:, None]
    valid = (pos < ln) & (pos >= ln - win)                 # (B, S)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qh = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bhrs", qh, k) * D ** -0.5
    p, m, l = softmax_state(s, valid[:, None, None, :])
    acc = torch.einsum("bhrs,bshd->bhrd", p, v)
    return acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def cascade_prefix_attention(
        qg: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
        group_tables: torch.Tensor, group_len: torch.Tensor,
        lane_lens: torch.Tensor, window: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One multi-query pass per shared chain.

    qg (G, Lc, Hq, D): the query rows of each group's lanes; group_tables
    (G, npre) the chain's block ids (trash-padded); group_len (G,) its
    tokens (0: an empty state); lane_lens (G, Lc) each lane's length.
    Position ``pos`` of the chain attends for lane c when ``pos <
    group_len[g]`` and ``pos >= lane_lens[g, c] - win``.  Returns the
    float32 state (acc (G, Lc, Hq, D), m, l (G, Lc, Hq))."""
    G, Lc, Hq, D = qg.shape
    Hkv = k_arena.shape[2]
    n_rep = Hq // Hkv
    win = window if window else NO_WINDOW
    t = group_tables.long()
    k = k_arena[t].reshape(G, -1, Hkv, D).float()         # (G, Sp, Hkv, D)
    v = v_arena[t].reshape(G, -1, Hkv, D).float()
    pos = torch.arange(k.shape[1], device=qg.device)
    in_chain = pos[None, :] < group_len.long()[:, None]    # (G, Sp)
    v = torch.where(in_chain[:, :, None, None], v, 0.0)
    valid = in_chain[:, None, :] & \
        (pos[None, None, :] >= lane_lens.long()[:, :, None] - win)
    qh = qg.reshape(G, Lc, Hkv, n_rep, D).float()
    s = torch.einsum("gchrd,gshd->gchrs", qh, k) * D ** -0.5
    p, m, l = softmax_state(s, valid[:, :, None, None, :])
    acc = torch.einsum("gchrs,gshd->gchrd", p, v)
    return (acc.reshape(G, Lc, Hq, D), m.reshape(G, Lc, Hq),
            l.reshape(G, Lc, Hq))


def merge_attn_states(acc1, m1, l1, acc2, m2, l2) -> torch.Tensor:
    """Merge two float32 states (acc (B, Hq, D), m and l (B, Hq)) and
    normalize: ``acc / max(l, 1e-30)``, float32."""
    acc, _, l = merge_softmax_states(acc1, m1, l1, acc2, m2, l2)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def merge_attn_states_n(acc: torch.Tensor, m: torch.Tensor,
                        l: torch.Tensor) -> torch.Tensor:
    """Merge S float32 states stacked on a leading axis (acc (S, *rows,
    D), m and l (S, *rows)) and normalize: with M the max of m over the
    states, ``sum exp(m - M) acc / max(sum exp(m - M) l, 1e-30)``, float32
    (*rows, D)."""
    c = torch.exp(m - m.amax(0))
    return (c[..., None] * acc).sum(0) / \
        torch.clamp((c * l).sum(0), min=1e-30)[..., None]


def paged_decode_attention_merged(
        q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
        tables: torch.Tensor, lens: torch.Tensor, window: int | None,
        q0: torch.Tensor | None,
        new_kv: tuple[torch.Tensor, torch.Tensor] | None, prefix: tuple
        ) -> torch.Tensor:
    """The suffix sweep with the cascade's merge fused, as the kernel
    computes it: :func:`paged_decode_attention_with_state`'s state, each
    lane's prefix state gathered from the group layout through its slot,
    :func:`merge_attn_states` (prefix first) and the cast.

    ``prefix`` = (acc (G, Lc, Hq, D), m, l (G, Lc, Hq) float32, lane_slot
    (B,) int32): lane b reads slot ``lane_slot[b]`` of the G * Lc flat
    slots; a slot outside ``[0, G * Lc)`` (-1: in no group) reads the empty
    state.  Returns (B, Hq, D) in v_arena's dtype."""
    acc2, m2, l2 = paged_decode_attention_with_state(
        q, k_arena, v_arena, tables, lens, window, q0, new_kv)
    acc, m, l, lane_slot = prefix
    G, Lc, Hq, D = acc.shape
    n = G * Lc
    slot = lane_slot.long()
    slot = torch.where((slot >= 0) & (slot < n), slot, n)   # n: the empty row
    acc1 = torch.cat([acc.reshape(n, Hq, D), acc.new_zeros((1, Hq, D))])
    m1 = torch.cat([m.reshape(n, Hq), m.new_full((1, Hq), NEG_INF)])
    l1 = torch.cat([l.reshape(n, Hq), l.new_zeros((1, Hq))])
    return merge_attn_states(acc1[slot], m1[slot], l1[slot], acc2, m2,
                             l2).to(v_arena.dtype)


# --------------------------------------------------------------------------
# Prompt attention: the reference oracle of the flash kernel, and the
# kernel's plain version (the online-softmax loops of the reference's
# ``attend_chunked``).
# --------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) (GQA)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The TPU kernel's oracle: naive softmax attention over (BH, S, D)
    (float32 scores and probabilities, ``-1e30`` above the diagonal when
    ``causal``), returned in v's dtype."""
    D = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * D ** -0.5
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(v.dtype)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            q_chunk: int = 512, kv_chunk: int = 1024,
                            return_lse: bool = False):
    """The flash kernel's plain version: q (B, Sq, Hq, D) against k, v
    (B, Sk, Hkv, D), GQA by repetition, query i at absolute position
    ``q_offset + i``.  Key j attends when ``rel = q_offset + i - j`` has
    ``rel < win`` and, if ``causal``, ``rel >= 0`` (``win`` is
    ``NO_WINDOW`` for a window of None or 0).

    Query chunks x key chunks with a float32 online softmax: scores, the
    running max and sum, and the accumulator are float32; the probabilities
    are cast to v's dtype before the value product; masked scores are
    ``NEG_INF``, so a chunk masked for a row before its first valid key
    gives that row p = 1 until the first real key's rescale (``corr = 0``)
    wipes it, as in the reference; the result is ``acc / max(l, 1e-30)``
    in v's dtype.  ``return_lse``: also the rows' float32 log-sum-exp ``m +
    log(max(l, 1e-30))`` (B, Sq, Hq), which the backward reads; the
    output's bits do not depend on it."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    n_rep = Hq // k.shape[2]
    kt = repeat_kv(k, n_rep).transpose(1, 2)               # (B, H, Sk, D)
    vt = repeat_kv(v, n_rep).transpose(1, 2)
    qt = q.transpose(1, 2)                                 # (B, H, Sq, D)
    win = window if window else NO_WINDOW
    scale = D ** -0.5
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, Sq, qc):
        q_i = qt[:, :, q0:q0 + qc].float()
        q_pos = q_offset + torch.arange(q0, q0 + q_i.shape[2], device=dev)
        m = torch.full(q_i.shape[:3], NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(q_i.shape, dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, kc):
            k_j, v_j = kt[:, :, k0:k0 + kc], vt[:, :, k0:k0 + kc]
            k_pos = torch.arange(k0, k0 + k_j.shape[2], device=dev)
            s = (q_i @ k_j.float().transpose(-1, -2)) * scale
            rel = q_pos[:, None] - k_pos[None, :]
            mask = rel < win
            if causal:
                mask &= rel >= 0
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(v.dtype).float() @ v_j.float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=2).transpose(1, 2).to(v.dtype)
    if not return_lse:
        return out
    return out, torch.cat(lses, dim=2).transpose(1, 2).contiguous()


def flash_attention_bwd_chunked(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                dout: torch.Tensor, lse: torch.Tensor,
                                causal: bool = True,
                                window: int | None = None, q_offset: int = 0,
                                q_chunk: int = 512, kv_chunk: int = 1024
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The backward kernel's plain version: the reference's FA2 backward
    (``repro/nn/attention.py`` ``_flash_bwd``) tile for tile.  q, out, dout
    (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); lse (B, Sq, Hq) float32 from the
    forward; the mask of :func:`flash_attention_chunked`.  Returns (dq, dk,
    dv) in q's, k's and v's dtypes.

    dout is widened to float32 first, and ``delta = rowsum(dout * out)``
    in float32; then for each key chunk (outer) and query chunk (inner):
    ``p = exp(s - lse)`` from the recomputed float32 scores, ``dv += p^T
    dout`` (dout is float32 here, so p is not rounded), ``dp = dout v^T``,
    ``ds = p (dp - delta) scale`` rounded to k's dtype, ``dq += ds k`` and
    ``dk += ds^T q``, all accumulated in float32; dq sums its key chunks in
    order.  K and V are repeated per query head (GQA), so each repeated
    head's dk and dv is cast to k's dtype and the group's heads are then
    summed, as the transpose of ``_repeat_kv``'s broadcast sums them."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    f32 = torch.float32
    kt = repeat_kv(k, n_rep).transpose(1, 2)               # (B, H, Sk, D)
    vt = repeat_kv(v, n_rep).transpose(1, 2)
    qt = q.transpose(1, 2)                                 # (B, H, Sq, D)
    g = dout.to(f32).transpose(1, 2)
    lse_t = lse.transpose(1, 2)                            # (B, H, Sq)
    delta = (g * out.to(f32).transpose(1, 2)).sum(-1)      # (B, H, Sq)
    win = window if window else NO_WINDOW
    scale = D ** -0.5
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    dev = q.device
    dq = torch.zeros((B, Hq, Sq, D), dtype=f32, device=dev)
    dks, dvs = [], []
    for k0 in range(0, Sk, kc):
        k_j, v_j = kt[:, :, k0:k0 + kc], vt[:, :, k0:k0 + kc]
        k_pos = torch.arange(k0, k0 + k_j.shape[2], device=dev)
        dk_j = torch.zeros(k_j.shape, dtype=f32, device=dev)
        dv_j = torch.zeros(k_j.shape, dtype=f32, device=dev)
        dq_inc = []
        for q0 in range(0, Sq, qc):
            q_i = qt[:, :, q0:q0 + qc]
            g_i = g[:, :, q0:q0 + qc]
            q_pos = q_offset + torch.arange(q0, q0 + q_i.shape[2],
                                            device=dev)
            s = (q_i.float() @ k_j.float().transpose(-1, -2)) * scale
            rel = q_pos[:, None] - k_pos[None, :]
            mask = rel < win
            if causal:
                mask &= rel >= 0
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse_t[:, :, q0:q0 + qc, None])
            dv_j = dv_j + p.transpose(-1, -2) @ g_i
            dp = g_i @ v_j.float().transpose(-1, -2)
            ds = p * (dp - delta[:, :, q0:q0 + qc, None]) * scale
            dsl = ds.to(k.dtype).float()
            dq_inc.append(dsl @ k_j.float())
            dk_j = dk_j + dsl.transpose(-1, -2) @ q_i.to(k.dtype).float()
        dq = dq + torch.cat(dq_inc, dim=2)
        dks.append(dk_j)
        dvs.append(dv_j)

    def heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        t = t.transpose(1, 2).to(dtype)                    # (B, Sk, Hq, D)
        if n_rep == 1:
            return t
        return t.reshape(B, Sk, Hkv, n_rep, D).sum(3)
    return (dq.transpose(1, 2).to(q.dtype),
            heads(torch.cat(dks, dim=2), k.dtype),
            heads(torch.cat(dvs, dim=2), v.dtype))
