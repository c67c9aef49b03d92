"""Serving engine of the port, decoder and moe families: one-shot
prefill, the chunked prefill fold's step and the batched single-token
decode ticks, against the dense cache and against the paged block arena.

Cache layout (leading axis = layers): k/v (L, B, Smax, Hkv, Dh) plus
``len``, a scalar or, in the dense tick, one length per lane.  The paged
arena splices a ``num_blocks`` axis in just before the batch axis of a
B=1, ``block_size``-long cache: (L, num_blocks, 1, bs, Hkv, Dh),
layer-leading, so one layer's slice is exactly what the paged attention
reads.

Unlike the reference, which rebuilds arrays functionally (and lets XLA
donate them), the decode ticks here write the cache and the arena **in
place**: the new token's K/V row per layer and lane lands at its position
(dense) or where the block table says (paged), and no other row changes.
The ticks embed their token without the SC frontend, as the reference's
do; prefill and every fold chunk run it (``lm.embed_tokens``).

The moe family runs its dense layer 0 first, then its MoE blocks
(:func:`repro_torch.models.lm.layers`); the cache and the arena keep
layer 0 for it.  Prefill and every fold chunk route with
``moe_dropless=cfg.moe_dropless_prefill``; on a tick each lane routes as
its own group of one token (``lm.moe_ffn_decode``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attn as paged_kernels
from repro_torch.kernels import ref
from repro_torch.models import lm

# Cache keys whose axis -3 is the (paged) sequence axis; the decoder and
# moe families have only k and v.
PAGED_SEQ_KEYS = ("k", "v")


def init_cache(cfg: lm.LMConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed dense cache: k/v (L, B, max_len, Hkv, Dh) and ``len``."""
    lm.check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_paged_arena(cfg: lm.LMConfig, num_blocks: int, block_size: int,
                     device: str | torch.device = "cuda") -> dict:
    """Block arenas for the paged KV cache: per sequence key, the B=1 cache
    of ``max_len=block_size`` with a ``num_blocks`` axis spliced in just
    before the batch axis — (L, num_blocks, 1, bs, Hkv, Dh)."""
    blk = init_cache(cfg, 1, block_size, device="meta")
    out = {}
    for key in PAGED_SEQ_KEYS:
        s = blk[key].shape                       # (L, 1, bs, Hkv, Dh)
        ax = len(s) - 4                          # just before the B axis
        out[key] = torch.zeros(s[:ax] + (num_blocks,) + s[ax:],
                               dtype=blk[key].dtype, device=device)
    return out


def arena_block_axis(a: torch.Tensor) -> int:
    """Block-id axis of an :func:`init_paged_arena` tensor (5 from the
    end, whatever the leading layer axes)."""
    return a.dim() - 5


def prefill(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor):
    """Process a whole prompt: one fold step from an empty prefix.  tokens
    (B, S) -> (cache, last-token logits (B, vocab_padded) float32); cache
    k/v (L, B, S, Hkv, Dh), len S."""
    return prefill_chunked(cfg, params, tokens,
                           init_cache(cfg, tokens.shape[0], 0, tokens.device),
                           0)


def prefill_chunked(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor,
                    cache: dict, q_offset: int):
    """Process one prompt chunk against an existing KV prefix: one step of
    the serving prefill fold.

    tokens (B, S_chunk): only the tokens past the prefix.  ``cache``: k/v
    (L, B, q_offset, Hkv, Dh), the prefix's post-RoPE rows (zero-length for
    a cold fold).  Returns (cache covering prefix and chunk, len
    ``q_offset + S_chunk``; the chunk's last-token logits (B, vocab_padded)
    float32).  Decoder and moe families (other families raise).

    A radix prefix hit of H blocks resumes the fold at chunk H with the
    prefix gathered from the arena.  Chunk j runs the same operations on
    the same inputs whether the fold started at 0 or at H <= j, so the
    resumed fold reproduces the cold fold's K/V and logits bit for bit.
    Every chunk concatenates the whole prefix in every layer and stacks the
    layers again, as the reference does."""
    lm.check_supported(cfg)
    B, S = tokens.shape
    if cache["k"].shape[-3] != q_offset:
        raise ValueError(f"prefix holds {cache['k'].shape[-3]} positions, "
                         f"q_offset is {q_offset}")
    x = lm.embed_tokens(cfg, params, tokens, pos_offset=q_offset)
    positions = torch.arange(q_offset, q_offset + S,
                             device=x.device).expand(B, S)
    ks, vs = [], []
    for i, (lp, window, moe_layer) in enumerate(lm.layers(cfg, params)):
        x, (k, v) = lm.decoder_block(
            cfg, lp, x, positions, window=window, q_offset=q_offset,
            kv_prefix=(cache["k"][i], cache["v"][i]), moe_layer=moe_layer,
            moe_dropless=cfg.moe_dropless_prefill)
        ks.append(k)
        vs.append(v)
    new_cache = {"len": torch.tensor(q_offset + S, dtype=torch.int32,
                                     device=x.device),
                 "k": torch.stack(ks), "v": torch.stack(vs)}
    return new_cache, lm.logits(cfg, params, x[:, -1:])[:, 0]


def decode_step(cfg: lm.LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, active: torch.Tensor | None = None):
    """One batched decode tick against the dense cache, each lane at its own
    position: the reference's ``decode_step`` vmapped over B=1 caches, as
    one batched step.

    cache   k/v (L, B, Smax, Hkv, Dh) and ``len`` (B,) int32 (or a scalar
            for every lane), **updated in place**: per layer and lane one
            K/V row at ``len``, and ``len + 1``.
    tokens  (B, 1) integer.
    active  optional (B,) bool: an inactive lane still decodes (its logits
            are computed) but its rows and length stay as they were, as the
            reference's adapter selects them.

    Returns (cache, logits (B, vocab_padded) float32)."""
    lm.check_supported(cfg)
    B = tokens.shape[0]
    pos = cache["len"].to(torch.int32).expand(B)
    x = lm.token_rows(params, tokens)                      # (B, 1, d)
    for i, (lp, window, moe_layer) in enumerate(lm.layers(cfg, params)):
        x = x + lm.attn_decode(cfg, lp["attn"],
                               lm._norm_apply(cfg, lp["ln1"], x),
                               cache["k"][i], cache["v"][i], pos,
                               window=window, active=active)
        x = x + lm.ffn_decode(cfg, lp, lm._norm_apply(cfg, lp["ln2"], x),
                              moe_layer)
    step = 1 if active is None else active.to(cache["len"].dtype)
    cache["len"] += step
    return cache, lm.logits(cfg, params, x)[:, 0]


def decode_step_paged(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor,
                      *, tables: torch.Tensor, lens: torch.Tensor,
                      arena: dict, wbids: torch.Tensor | None = None,
                      backend: str = "plain", cascade: dict | None = None
                      ) -> torch.Tensor:
    """One batched decode tick reading K/V in place from the block arena.

    tokens  (S, 1) int32, one per slot lane.
    tables  (S, nb) int32 arena block ids (trash-padded past each chain).
    lens    (S,) int32 lengths; the new token lands at position ``lens``.
    arena   :func:`init_paged_arena` dict, **updated in place**: one K and
            one V row per layer and lane at (``wbids``, ``lens % bs``).
    wbids   (S,) int32 block each lane's row lands in; the caller routes
            lanes that must not write to the trash block 0.  ``None``
            derives it from the table, routing lanes past the table to 0.
    backend ``"plain"`` (gather + masked softmax, indexed write),
            ``"cuda"`` (the ``paged_decode_attention`` kernel in every
            layer and one ``scatter_kv_rows`` launch after the layer loop,
            from the layers' rows)
            or ``"cascade"`` (shared-prefix cascade attention in every
            layer from the group metadata ``cascade``, see
            :func:`repro_torch.nn.attention.attend_decode_cascade`; the
            same write as ``"cuda"``, whose wrapper runs the plain write
            for CPU tensors).

    The decoder and moe families have no slot state besides ``lens``
    (the caller's).
    Returns the logits (S, vocab_padded) float32."""
    lm.check_supported(cfg)
    if backend not in ("plain", "cuda", "cascade"):
        raise ValueError(f"unknown decode backend {backend!r}")
    bs = arena["k"].shape[-3]
    nb = tables.shape[1]
    pos = lens.to(torch.int32)
    offs = pos % bs
    if wbids is None:
        blk = tables.gather(1, (pos // bs).clamp(max=nb - 1).long()[:, None])
        wbids = torch.where(pos >= nb * bs, 0, blk[:, 0])
    x = lm.token_rows(params, tokens)                      # (S, 1, d)
    k_rows, v_rows = [], []
    for i, (lp, window, moe_layer) in enumerate(lm.layers(cfg, params)):
        h, k1, v1 = lm.attn_decode_paged(
            cfg, lp["attn"], lm._norm_apply(cfg, lp["ln1"], x),
            arena["k"][i], arena["v"][i], tables, pos, window=window,
            backend=backend, cascade=cascade)
        x = x + h
        x = x + lm.ffn_decode(cfg, lp, lm._norm_apply(cfg, lp["ln2"], x),
                              moe_layer)
        k_rows.append(k1)
        v_rows.append(v1)
    # the tick's only sequence-axis write: one (S, Hkv, Dh) row per layer,
    # landed after the layer loop so every layer read the arena as it was;
    # the kernel takes the layers' rows where they lie (no stacked copy)
    wbids, offs = wbids.to(torch.int32), offs.to(torch.int32)
    scatter = ref.scatter_kv_rows if backend == "plain" else \
        paged_kernels.scatter_kv_rows
    scatter(arena["k"], arena["v"], k_rows, v_rows, wbids, offs)
    return lm.logits(cfg, params, x)[:, 0]
