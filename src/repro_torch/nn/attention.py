"""Attention: chunked online-softmax prefill, dense single-token decode and
paged single-token decode.

``attend_chunked`` is the reference's flash-style prefill (query chunks x KV
chunks, float32 online softmax) written as plain PyTorch loops, forward only.
``attend_decode_paged`` reads K/V through a block table: its ``"plain"``
backend gathers each lane's chain and applies the masked softmax (the
reference's ``"xla"`` body); its ``"cuda"`` backend calls the
``paged_decode_attention`` kernel, which reads the blocks in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attn as paged_kernels
from repro_torch.kernels.ref import NEG_INF, NO_WINDOW, splice_rows


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) (GQA)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, Hq, D) in
    v's dtype.

    Scores, the running max and sum, and the accumulator are float32; the
    probabilities are cast to v's dtype before the value product, as in the
    reference.  ``window`` > 0 masks keys more than ``window - 1`` positions
    behind the query; ``q_offset`` is the absolute position of q[:, 0]."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    n_rep = Hq // k.shape[2]
    kt = _repeat_kv(k, n_rep).transpose(1, 2)             # (B, H, Sk, D)
    vt = _repeat_kv(v, n_rep).transpose(1, 2)
    qt = q.transpose(1, 2)                                 # (B, H, Sq, D)
    win = window if window else NO_WINDOW
    scale = D ** -0.5
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    dev = q.device
    outs = []
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
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out.to(v.dtype)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int, *,
                  window: int = 0) -> torch.Tensor:
    """One-token decode attention against a dense cache.

    q: (B, 1, Hq, D); k_cache, v_cache: (B, Smax, Hkv, D); the new token's
    K/V already written at ``cache_len - 1``."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qh = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhrd,bshd->bhrs", qh, k_cache.float()) * D ** -0.5
    pos = torch.arange(Smax, device=q.device)
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
                        backend: str = "plain") -> torch.Tensor:
    """One-token decode attention against a paged cache (one layer).

    q: (B, 1, Hq, D); k_arena, v_arena: (num_blocks, bs, Hkv, D);
    block_table: (B, nb) int32; cache_len: (B,) int32 valid lengths.
    ``new_kv``: optional (k1, v1), each (B, Hkv, D), the current token's row,
    read at ``cache_len - 1`` in place of the arena's.

    ``backend="plain"`` gathers and applies the masked softmax (the
    reference's ``"xla"`` body; probabilities cast to v's dtype before the
    value product); ``"cuda"`` runs the ``paged_decode_attention`` kernel
    (no gather, no cast of the probabilities).  Returns (B, 1, Hq, D) in
    v_arena's dtype."""
    if backend == "cuda":
        return paged_kernels.paged_decode_attention(
            q[:, 0], k_arena, v_arena, block_table, cache_len,
            window=window, new_kv=new_kv)[:, None]
    if backend != "plain":
        raise ValueError(f"unknown attention backend {backend!r}")
    B, _, Hq, D = q.shape
    Hkv = k_arena.shape[2]
    k = gather_paged_kv(k_arena, block_table)        # (B, S, Hkv, D)
    v = gather_paged_kv(v_arena, block_table)
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
