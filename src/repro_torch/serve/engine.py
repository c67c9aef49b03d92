"""Serving engine of the port, decoder, moe, hybrid, encdec, vlm and rwkv
families: one-shot prefill, the chunked prefill fold's step and the batched
single-token decode ticks, against the dense cache and against the paged
block arena (the rwkv family: one-shot prefill and the dense tick over its
recurrent state only).

Cache layout (leading axis = layers): k/v (L, B, Smax, Hkv, Dh) plus
``len``, a scalar or, in the dense tick, one length per lane; the hybrid
family adds its recurrent state, ``conv`` (L, B, K-1, d_inner) in the
model's dtype and ``ssm`` (L, B, d_inner, N) in float32; the encdec
family adds the encoder's cross K/V of every decoder layer, ``xk`` and
``xv`` (L, B, enc_len, Hkv, Dh) in the model's dtype
(:func:`encode_cross`), the vlm family the vision tokens' cross K/V of
each of its G cross layers, ``xk`` and ``xv`` (G, B, n_vision_tokens, Hkv,
Dh) (:func:`vision_cross`).  The rwkv family has no K/V at all: its cache
is its recurrent state, ``wkv`` (L, B, H, Dh, Dh) in float32 and the
token-shift rows ``shift1`` / ``shift2`` (L, B, d) in the model's dtype,
O(1) in the context, so there is nothing to page and no fold to resume:
its prompts are admitted one-shot (:func:`prefill`, in chunks of
``min(rwkv_chunk, S)``, so S must be a multiple of that, as the reference
asserts), and its tick (:func:`decode_step`) advances the state in place.
The paged arena, the fold and the paged tick refuse the family
(``ValueError``), as the reference asserts ("rwkv has O(1) state; nothing
to page").  The paged arena splices a ``num_blocks`` axis in
just before the batch axis of a B=1, ``block_size``-long cache: (L,
num_blocks, 1, bs, Hkv, Dh), layer-leading, so one layer's slice is
exactly what the paged attention reads; the recurrent state and the cross
K/V are not sequence keys and stay out of it (the paged adapter keeps them
per lane, (L, n_slots, ...): its lane state).

Unlike the reference, which rebuilds arrays functionally (and lets XLA
donate them), the decode ticks here write the cache, the arena and the
recurrent state **in place**: the new token's K/V row per layer and lane
lands at its position (dense) or where the block table says (paged), a
lane's state is overwritten by its next state, and nothing else changes.
The ticks embed their token without the SC frontend, as the reference's
do; prefill and every fold chunk run it (``lm.embed_tokens``).

The moe family runs its dense layer 0 first, then its MoE blocks
(:func:`repro_torch.models.lm.layers`); the cache and the arena keep
layer 0 for it.  Prefill and every fold chunk route with
``moe_dropless=cfg.moe_dropless_prefill``; on a tick each lane routes as
its own group of one token (``lm.moe_ffn_decode``).

The hybrid family scans a prompt or fold chunk of S tokens in chunks of
``min(ssm_chunk, S)`` steps, so its one-shot prefill refuses a prompt
that is not a multiple of that chunk, as the reference does; the fold
takes any length, each chunk being one scan chunk.

The encdec family runs its encoder once per admission
(:func:`encode_cross`: the frame embeddings plus the sinusoidal table,
the non-causal encoder blocks, the final norm, then each decoder layer's
cross K and V); every chunk of a fold reads the same cross K/V, and a
tick attends them in plain PyTorch, as the reference's tick does in XLA.

The vlm family keeps one flat, layer-ordered cache and arena, as the
other families do, where the reference keeps a grouped one for its
``jax.lax.scan``: with k = ``cross_every``, the reference's ``k[g, j]``
(G, k - 1, ...) is the port's layer g k + j, and its ``kx_self[g]`` (its
cross layers' self K/V) is layer g k + k - 1 (:func:`lm.layers`).  Its
cross K/V come from the vision embedding once per admission
(:func:`vision_cross`), and its prompts are admitted one-shot: the
reference leaves the family out of the chunked fold
(:func:`prefill_chunked` refuses it), and its tick runs the plain
in-place read (``backend="plain"``; :func:`decode_step_paged` refuses the
kernels' backends, as the reference refuses them).

Over a serving slice's ``"model"`` axis the arena is split by the
reference's specs (:func:`cache_specs`, :func:`arena_specs`) into one
:class:`ArenaShard` per device (:func:`shard_arena`): KV heads when the
slice's width divides ``n_kv_heads``, else each block's positions (the
split-KV fallback); :func:`decode_step_paged` takes the shards in place of
the arena dict.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import P, axis_if_divisible, batch_spec_axis
from repro_torch.kernels import paged_attn as paged_kernels
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.serve import kvquant

# Cache keys whose axis -3 is the (paged) sequence axis: k and v, and their
# scales under ``kv_quant`` (the hybrid family's conv and ssm state and the
# encdec and vlm families' cross K/V are per lane, not per position).
PAGED_SEQ_KEYS = ("k", "v", "k_scale", "v_scale")
# the int8 layout's scale keys, per (token, head)
SCALE_KEYS = ("k_scale", "v_scale")
# the families whose K/V ``kv_quant`` stores int8 (the encdec and vlm
# families ignore it, as in the reference; the rwkv family has no K/V)
QUANT_FAMILIES = ("decoder", "moe", "hybrid")
# the hybrid family's recurrent state, per layer and lane
STATE_KEYS = ("conv", "ssm")
# the rwkv family's recurrent state, per layer and lane: its whole context
RWKV_KEYS = ("wkv", "shift1", "shift2")
# the encdec and vlm families' cross K/V, per cross layer and lane
CROSS_KEYS = ("xk", "xv")
# the keyword of each family's cross-attention input, the reference's
# batch extras: the encoder's frames, the vision tower's patches
EXTRAS_KEYS = {"encdec": "enc_embed", "vlm": "vision_embed"}


def init_state(cfg: lm.LMConfig, batch: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed lane state: the hybrid family's recurrent state, conv (L,
    B, K-1, d_inner) in the model's dtype and ssm (L, B, d_inner, N)
    float32; the rwkv family's, wkv (L, B, H, Dh, Dh) float32 and shift1
    / shift2 (L, B, d) in the model's dtype; the encdec and vlm families'
    cross K/V, xk / xv (n_cross, B, cross_len, Hkv, Dh) in the model's
    dtype (``lm.LMConfig.n_cross``, ``cross_len``); an empty dict for the
    other families."""
    L = cfg.n_layers
    if cfg.family == "rwkv":
        wkv = (L, batch, cfg.n_heads, cfg.d_head, cfg.d_head)
        return {"wkv": torch.zeros(wkv, dtype=torch.float32, device=device),
                **{key: torch.zeros((L, batch, cfg.d_model), dtype=cfg.dtype,
                                    device=device)
                   for key in ("shift1", "shift2")}}
    if cfg.n_cross:
        shape = (cfg.n_cross, batch, cfg.cross_len, cfg.n_kv_heads,
                 cfg.d_head)
        return {key: torch.zeros(shape, dtype=cfg.dtype, device=device)
                for key in CROSS_KEYS}
    if cfg.family != "hybrid":
        return {}
    return {"conv": torch.zeros((L, batch, cfg.conv_k - 1, cfg.inner),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((L, batch, cfg.inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def quantized(cfg: lm.LMConfig) -> bool:
    """Whether ``cfg``'s K/V are stored int8 (``kv_quant`` on a family of
    :data:`QUANT_FAMILIES`)."""
    return cfg.kv_quant and cfg.family in QUANT_FAMILIES


def init_cache(cfg: lm.LMConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Zeroed dense cache: k/v (L, B, max_len, Hkv, Dh), ``len`` and the
    lane state (:func:`init_state`); under :func:`quantized` k/v int8 and
    k_scale / v_scale (L, B, max_len, Hkv, 1) float32; for the rwkv family
    ``len`` and its state only, whatever ``max_len`` is."""
    lm.check_supported(cfg)
    if cfg.family == "rwkv":
        return {"len": torch.zeros((), dtype=torch.int32, device=device),
                **init_state(cfg, batch, device)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if quantized(cfg) else cfg.dtype
    cache = {"len": torch.zeros((), dtype=torch.int32, device=device),
             "k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if quantized(cfg):
        for key in SCALE_KEYS:
            cache[key] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                     device=device)
    return {**cache, **init_state(cfg, batch, device)}


def empty_cache(cfg: lm.LMConfig, batch: int,
                device: str | torch.device = "cuda") -> dict:
    """The prefix cache of a cold fold: k/v of no positions, ``len`` 0 and
    the hybrid family's zero state; not the cross K/V, which each
    admission provides (:func:`cross_kv`)."""
    return {key: torch.zeros(a.shape, dtype=a.dtype, device=device)
            for key, a in init_cache(cfg, batch, 0, "meta").items()
            if key not in CROSS_KEYS}


def init_paged_arena(cfg: lm.LMConfig, num_blocks: int, block_size: int,
                     device: str | torch.device = "cuda") -> dict:
    """Block arenas for the paged KV cache: per sequence key, the B=1 cache
    of ``max_len=block_size`` with a ``num_blocks`` axis spliced in just
    before the batch axis — (L, num_blocks, 1, bs, Hkv, Dh).  The rwkv
    family has nothing to page (``ValueError``)."""
    _refuse_rwkv(cfg, "the paged arena")
    blk = init_cache(cfg, 1, block_size, device="meta")
    out = {}
    for key in PAGED_SEQ_KEYS:
        if key not in blk:
            continue
        s = blk[key].shape                       # (L, 1, bs, Hkv, Dh)
        ax = len(s) - 4                          # just before the B axis
        out[key] = torch.zeros(s[:ax] + (num_blocks,) + s[ax:],
                               dtype=blk[key].dtype, device=device)
    return out


def _refuse_rwkv(cfg: lm.LMConfig, what: str) -> None:
    if cfg.family == "rwkv":
        raise ValueError(f"{what} does not cover the rwkv family: rwkv has "
                         "O(1) state; nothing to page (the reference "
                         "asserts it)")


def arena_block_axis(a: torch.Tensor) -> int:
    """Block-id axis of an :func:`init_paged_arena` tensor (5 from the
    end, whatever the leading layer axes)."""
    return a.dim() - 5


# ==========================================================================
# Sharding over a slice's "model" axis.
# ==========================================================================

def cache_specs(cfg: lm.LMConfig, mesh_shape: dict[str, int],
                batch: int) -> dict[str, P]:
    """Partition specs matching :func:`init_cache` (the reference's
    ``cache_specs``): the batch axis over the DP axes where they divide
    it; KV heads over ``"model"`` when it divides ``n_kv_heads``, else the
    sequence axis over ``"model"`` (the split-KV fallback); the hybrid
    family's inner width and the rwkv family's heads over ``"model"`` when
    divisible.  The vlm family's flat, layer-ordered k / v (L, B, Smax,
    Hkv, Dh) get the spec the reference gives its grouped ``k`` (G, k - 1,
    ...) and ``kx_self`` (G, ...), at the port's rank: the reference's
    entries after its leading group axes."""
    b = batch_spec_axis(mesh_shape, batch)
    kv_heads = axis_if_divisible("model", cfg.n_kv_heads, mesh_shape)
    seq = None if kv_heads else "model"              # split-KV fallback
    kv = P(None, b, seq, kv_heads, None)
    specs = {"len": P()}
    if cfg.family == "rwkv":
        h = axis_if_divisible("model", cfg.n_heads, mesh_shape)
        specs["wkv"] = P(None, b, h, None, None)
        specs["shift1"] = specs["shift2"] = P(None, b, None)
        return specs
    specs["k"] = specs["v"] = kv
    if quantized(cfg):
        for key in SCALE_KEYS:
            specs[key] = kv
    if cfg.family == "hybrid":
        di = axis_if_divisible("model", cfg.inner, mesh_shape)
        specs["conv"] = P(None, b, None, di)
        specs["ssm"] = P(None, b, di, None)
    if cfg.n_cross:
        for key in CROSS_KEYS:
            specs[key] = kv
    return specs


def arena_specs(cfg: lm.LMConfig, mesh_shape: dict[str, int]
                ) -> dict[str, P]:
    """Partition specs matching :func:`init_paged_arena`: the dense B=1
    spec of :func:`cache_specs` with a replicated block axis spliced in
    just before the batch axis, so KV heads shard over ``"model"`` when
    divisible and the block-size axis otherwise; the block axis never
    shards (slices partition the arena by pool, ``serve/shard/``)."""
    _refuse_rwkv(cfg, "the paged arena")
    dense = cache_specs(cfg, mesh_shape, batch=1)
    out = {}
    for key in PAGED_SEQ_KEYS:
        if key in dense:
            sp = tuple(dense[key])
            ax = len(sp) - 4                     # just before the B axis
            out[key] = P(*sp[:ax], None, *sp[ax:])
    return out


@dataclasses.dataclass
class ArenaShard:
    """One device's part of a paged arena split over a slice's ``"model"``
    axis (:func:`shard_arena`): ``arrays`` holds every sequence key at
    the KV heads ``heads`` = [lo, hi) and the in-block positions
    ``positions`` = [lo, hi) of the whole arena's, on ``device``.  A head
    split holds every position of its heads; a shard of the split-KV
    fallback holds every head at ``positions[1] - positions[0]`` of each
    block's positions."""
    arrays: dict
    device: torch.device
    heads: tuple[int, int]
    positions: tuple[int, int]

    def part(self, t: torch.Tensor) -> torch.Tensor:
        """This shard's part of a tensor in the arena's trailing layout
        (..., bs, Hkv, Dh or 1), a view on ``t``'s device."""
        (p0, p1), (h0, h1) = self.positions, self.heads
        return t[..., p0:p1, h0:h1, :]


def _model_axis(spec) -> int | None:
    """The trailing axis a spec shards over ``"model"`` (None: none)."""
    sp = tuple(spec)
    return sp.index("model") - len(sp) if "model" in sp else None


def shard_arena(arena: dict, specs: dict, devices) -> list[ArenaShard]:
    """An :func:`init_paged_arena` dict split over ``devices`` by
    ``specs`` (:func:`arena_specs`): the one axis a key's spec names
    ``"model"`` (KV heads, or the block-size axis under the split-KV
    fallback) into ``len(devices)`` equal contiguous ranges, range d a
    copy on ``devices[d]`` (zeros for an arena on the ``"meta"`` device, so
    a slice never holds the whole arena anywhere).  Returns one
    :class:`ArenaShard` per device, recording the range it holds, so the
    readers map a shard's heads back to their query heads and its rows
    back to their positions."""
    devices = [torch.device(d) for d in devices]
    m = len(devices)
    k = arena["k"]
    bs, Hkv = k.shape[-3], k.shape[-2]
    axes = {_model_axis(specs[key]) for key in arena}
    if len(axes) != 1 or not axes <= {-2, -3}:
        raise ValueError(f"arena specs {specs} do not shard one KV head or "
                         "block-size axis alike")
    ax = axes.pop()
    size = Hkv if ax == -2 else bs
    if size % m:
        raise ValueError(f"{size} {'KV heads' if ax == -2 else 'positions'}"
                         f" do not split over {m} devices")
    n = size // m
    out = []
    for d, dev in enumerate(devices):
        rng = (d * n, (d + 1) * n)
        shard = ArenaShard({}, dev, rng if ax == -2 else (0, Hkv),
                           rng if ax == -3 else (0, bs))
        for key, a in arena.items():
            part = shard.part(a)
            shard.arrays[key] = torch.zeros(part.shape, dtype=a.dtype,
                                            device=dev) \
                if a.device.type == "meta" else \
                part.to(dev, copy=True).contiguous()
        out.append(shard)
    return out


def shard_axis(shards: list[ArenaShard]) -> int:
    """The trailing axis the shards split: -3 (in-block positions, the
    split-KV fallback) or -2 (KV heads, and a single shard)."""
    return -3 if shards[0].positions != shards[-1].positions else -2


def join_parts(shards: list[ArenaShard], parts, device) -> torch.Tensor:
    """The whole tensor from the shards' parts (each in the arena's
    trailing layout), joined in head or position order on ``device``; a
    single shard's part as it is."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=shard_axis(shards))


def layer_shards(shards: list[ArenaShard], i: int, quant: bool
                 ) -> list[attention.KVShard]:
    """Layer ``i`` of each arena shard as the attention reads it: k / v
    (num_blocks, bs_d, Hkv_d, Dh) and, under ``quant``, the scales."""
    return [attention.KVShard(
        sh.arrays["k"][i][:, 0], sh.arrays["v"][i][:, 0],
        tuple(sh.arrays[key][i][:, 0] for key in SCALE_KEYS)
        if quant else None, sh.device, sh.heads, sh.positions)
        for sh in shards]


def _put(dst: torch.Tensor, new: torch.Tensor,
         active: torch.Tensor | None) -> None:
    """``dst`` (B, ...) overwritten in place by ``new``, an inactive
    lane's row put back as it was."""
    if active is not None:
        new = torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, dst)
    dst.copy_(new)


def encode_cross(cfg: lm.LMConfig, params: dict, enc_embed: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encdec family's encoder pass and every decoder layer's cross K/V
    projections: ``enc_embed`` (B, enc_len, d) frame embeddings, cast to
    the model's dtype, plus the sinusoidal table from 0, through the
    non-causal encoder blocks and ``enc_norm``.  Returns (xk, xv), each
    (L, B, enc_len, Hkv, Dh) in the model's dtype; xv carries the
    cross-attention's ``bv``, xk no bias, as in the reference.  One call
    per admission feeds every chunk of its fold."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_cross runs the encdec family's encoder, "
                         f"not {cfg.family!r}'s")
    B, T, _ = enc_embed.shape
    t = torch.arange(T, device=enc_embed.device)
    enc = enc_embed.to(cfg.dtype)
    enc = enc + lm.sinusoidal(t, cfg.d_model).to(enc.dtype)
    pos = t.expand(B, T)
    for i in range(cfg.enc_layers):
        enc, _, _ = lm.decoder_block(
            cfg, lm.layer_params(params["enc_blocks"], i), enc, pos,
            causal=False)
    enc = lm._norm_apply(cfg, params["enc_norm"], enc)
    shape = (B, T, cfg.n_kv_heads, cfg.d_head)
    xk, xv = [], []
    for i in range(cfg.n_layers):
        xa = lm.layer_params(params["dec_blocks"]["xattn"], i)
        xk.append(lm._proj(enc, xa["wk"]).reshape(shape))
        xv.append(lm._proj(enc, xa["wv"], xa.get("bv")).reshape(shape))
    return torch.stack(xk), torch.stack(xv)


def vision_cross(cfg: lm.LMConfig, params: dict, vision_embed: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The vlm family's cross K/V: ``vision_embed`` (B, n_vision_tokens, d)
    patch embeddings, cast to the model's dtype, through each cross layer's
    ``xattn`` ``wk`` and ``wv``, with no bias, as the reference's prefill
    projects them per group.  Returns (xk, xv), each (G, B,
    n_vision_tokens, Hkv, Dh) in the model's dtype."""
    if cfg.family != "vlm":
        raise ValueError(f"vision_cross projects the vlm family's vision "
                         f"tokens, not {cfg.family!r}'s")
    vis = vision_embed.to(cfg.dtype)
    shape = (vis.shape[0], vis.shape[1], cfg.n_kv_heads, cfg.d_head)
    xa = params["cross_blocks"]["xattn"]
    return (torch.stack([lm._proj(vis, w).reshape(shape) for w in xa["wk"]]),
            torch.stack([lm._proj(vis, w).reshape(shape) for w in xa["wv"]]))


def cross_kv(cfg: lm.LMConfig, params: dict, *,
             enc_embed: torch.Tensor | None = None,
             vision_embed: torch.Tensor | None = None) -> dict:
    """An admission's cross K/V, ``{"xk", "xv"}``: the encdec family's
    from its frames ``enc_embed`` (:func:`encode_cross`), the vlm family's
    from its patches ``vision_embed`` (:func:`vision_cross`); {} for the
    other families.  Each family needs its own input and refuses the
    other's (``ValueError``)."""
    given = {key: a for key, a in (("enc_embed", enc_embed),
                                   ("vision_embed", vision_embed))
             if a is not None}
    want = EXTRAS_KEYS.get(cfg.family)
    if set(given) != ({want} if want else set()):
        need = f"{want} and only it" if want else "neither enc_embed nor " \
            "vision_embed"
        raise ValueError(f"the {cfg.family} family's prefill takes {need} "
                         f"(got {sorted(given)})")
    if not want:
        return {}
    fn = encode_cross if cfg.family == "encdec" else vision_cross
    return dict(zip(CROSS_KEYS, fn(cfg, params, given[want])))


def prefill(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor, *,
            enc_embed: torch.Tensor | None = None,
            vision_embed: torch.Tensor | None = None):
    """Process a whole prompt.  tokens (B, S) -> (cache, last-token logits
    (B, vocab_padded) float32); cache k/v (L, B, S, Hkv, Dh), len S, and
    the lane state after the prompt: one fold step from an empty prefix
    (hybrid: a prompt of S tokens must be a multiple of ``min(cfg.ssm_chunk,
    S)``, else ``ValueError``).  The encdec family needs the frame
    embeddings ``enc_embed`` (B, enc_len, d) and the vlm family the patch
    embeddings ``vision_embed`` (B, n_vision_tokens, d), which give the
    cross K/V first (:func:`cross_kv`); the other families refuse both.
    The rwkv family's cache is ``len`` and its state after the prompt
    (:func:`_rwkv_prefill`).  Under :func:`quantized` the returned k/v are
    int8 with their k_scale / v_scale (``kvquant.quantize``), as the
    reference's prefill returns them."""
    lm.check_supported(cfg)
    if cfg.family == "rwkv":
        cross_kv(cfg, params, enc_embed=enc_embed, vision_embed=vision_embed)
        return _rwkv_prefill(cfg, params, tokens)
    cache = {**empty_cache(cfg, tokens.shape[0], tokens.device),
             **cross_kv(cfg, params, enc_embed=enc_embed,
                        vision_embed=vision_embed)}
    cache, logits = _fold_step(cfg, params, tokens, cache, 0)
    if quantized(cfg):
        cache["k"], cache["k_scale"] = kvquant.quantize(cache["k"])
        cache["v"], cache["v_scale"] = kvquant.quantize(cache["v"])
    return cache, logits


def prefill_chunked(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor,
                    cache: dict, q_offset: int):
    """Process one prompt chunk against an existing KV prefix: one step of
    the serving prefill fold.

    tokens (B, S_chunk): only the tokens past the prefix.  ``cache``: k/v
    (L, B, q_offset, Hkv, Dh), the prefix's rows (zero-length for a cold
    fold); for the hybrid family conv / ssm, the recurrent state at
    ``q_offset`` (zeros for a cold fold); for the encdec family xk / xv,
    the admission's :func:`encode_cross`; all read and not written.
    Returns (cache covering prefix and chunk, len ``q_offset + S_chunk``,
    with the state after the chunk and the same xk / xv; the chunk's
    last-token logits (B, vocab_padded) float32).  The vlm family is
    refused (``ValueError``), as the reference's fold asserts it out: its
    prompts are admitted one-shot (:func:`prefill`).  So is the int8
    layout (``kv_quant``, ``ValueError``): the fold needs the prefix's
    unquantized K/V, which the int8 cache no longer holds.

    A radix prefix hit of H blocks resumes the fold at chunk H with the
    prefix gathered from the arena (and, hybrid, the boundary state the
    cold fold left there).  Chunk j runs the same operations on the same
    inputs whether the fold started at 0 or at H <= j, so the resumed fold
    reproduces the cold fold's K/V, state and logits bit for bit.  Every
    chunk concatenates the whole prefix in every layer and stacks the
    layers again, as the reference does.  The rwkv family has no fold
    (``ValueError``)."""
    lm.check_supported(cfg)
    _refuse_rwkv(cfg, "the chunked prefill fold")
    if cfg.family == "vlm":
        raise ValueError("the chunked prefill fold does not cover the vlm "
                         "family (the reference leaves it out); admit its "
                         "prompts one-shot")
    if cfg.kv_quant:
        raise ValueError("the chunked prefill fold does not cover the int8 "
                         "kv_quant layout (the reference asserts it out); "
                         "admit its prompts one-shot")
    return _fold_step(cfg, params, tokens, cache, q_offset)


def _rwkv_prefill(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor):
    """The rwkv family's one-shot prefill: every block from a zero state
    (``lm.rwkv_block``).  Returns ({"len": S, "wkv", "shift1", "shift2"},
    each state stacked over the layers; the last token's logits)."""
    B, S = tokens.shape
    x = lm.embed_tokens(cfg, params, tokens)
    zero = init_state(cfg, B, x.device)
    out = {key: [] for key in RWKV_KEYS}
    for i, (lp, _, _, _) in enumerate(lm.layers(cfg, params)):
        x, st = lm.rwkv_block(cfg, lp, x,
                              {key: zero[key][i] for key in RWKV_KEYS})
        for key in RWKV_KEYS:
            out[key].append(st[key])
    cache = {"len": torch.tensor(S, dtype=torch.int32, device=x.device),
             **{key: torch.stack(ts) for key, ts in out.items()}}
    return cache, lm.logits(cfg, params, x[:, -1:])[:, 0]


def _fold_step(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor,
               cache: dict, q_offset: int):
    """:func:`prefill_chunked`'s step for every family: the one-shot
    prefill is this step from an empty prefix."""
    B, S = tokens.shape
    if cache["k"].shape[-3] != q_offset:
        raise ValueError(f"prefix holds {cache['k'].shape[-3]} positions, "
                         f"q_offset is {q_offset}")
    hybrid = cfg.family == "hybrid"
    x = lm.embed_tokens(cfg, params, tokens, pos_offset=q_offset)
    positions = torch.arange(q_offset, q_offset + S,
                             device=x.device).expand(B, S)
    out = {key: [] for key in ("k", "v") + (STATE_KEYS if hybrid
                                              else ())}
    for i, (lp, window, moe_layer, cross) in enumerate(
            lm.layers(cfg, params)):
        prefix = (cache["k"][i], cache["v"][i])
        st = {}
        if hybrid:
            x, (k, v), st = lm.hymba_block(
                cfg, lp, x, positions,
                {key: cache[key][i] for key in STATE_KEYS}, window=window,
                q_offset=q_offset, kv_prefix=prefix)
        elif cross is not None:
            x, (k, v) = lm.cross_block(
                cfg, lp, x, positions,
                (cache["xk"][cross], cache["xv"][cross]),
                q_offset=q_offset, kv_prefix=prefix)
        else:
            x, (k, v), _ = lm.decoder_block(
                cfg, lp, x, positions, window=window, q_offset=q_offset,
                kv_prefix=prefix, moe_layer=moe_layer,
                moe_dropless=cfg.moe_dropless_prefill)
        for key, t in (("k", k), ("v", v), *st.items()):
            out[key].append(t)
    new_cache = {"len": torch.tensor(q_offset + S, dtype=torch.int32,
                                     device=x.device),
                 **{key: torch.stack(ts) for key, ts in out.items()}}
    if cfg.n_cross:
        new_cache.update({key: cache[key] for key in CROSS_KEYS})
    return new_cache, lm.logits(cfg, params, x[:, -1:])[:, 0]


def _block_tail(cfg: lm.LMConfig, lp: dict, x: torch.Tensor,
                z: torch.Tensor, att: torch.Tensor, moe_layer: bool,
                state: dict, i: int, cross: int | None,
                active: torch.Tensor | None) -> torch.Tensor:
    """A decode tick's block after its attention ``att`` (from the normed
    ``z``): the residual, for a cross block the gated cross-attention over
    ``state``'s xk / xv at index ``cross``, and the FFN; or for the hybrid
    family the SSM branch from layer ``i`` of ``state`` (whose lanes' taps
    and state it overwrites in place, an inactive lane's put back), the mix
    and the MLP."""
    if cfg.family != "hybrid":
        x = x + att
        if cross is not None:
            x = x + lm.cross_decode(cfg, lp, x, state["xk"][cross],
                                    state["xv"][cross])
        return x + lm.ffn_decode(cfg, lp, lm._norm_apply(cfg, lp["ln2"], x),
                                 moe_layer)
    y, conv, h = lm.ssm_decode(cfg, lp, z, state["conv"][i],
                               state["ssm"][i])
    _put(state["conv"][i], conv, active)
    _put(state["ssm"][i], h, active)
    return lm.hymba_mix(cfg, lp, x, att, y)


def decode_step(cfg: lm.LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, active: torch.Tensor | None = None):
    """One batched decode tick against the dense cache, each lane at its own
    position: the reference's ``decode_step`` vmapped over B=1 caches, as
    one batched step.

    cache   k/v (L, B, Smax, Hkv, Dh), ``len`` (B,) int32 (or a scalar
            for every lane) and the lane state (the hybrid family's conv /
            ssm, the encdec and vlm families' xk / xv), **updated in
            place**: per layer and lane one K/V row at ``len``, the
            lane's next recurrent state, and ``len + 1`` (the cross K/V
            are read only); under :func:`quantized` the rows land int8
            with their scales, and attention reads the cache dequantized.
            The rwkv family's cache is ``len`` and its
            state (wkv, shift1, shift2), each lane's overwritten by its
            next.
    tokens  (B, 1) integer.
    active  optional (B,) bool: an inactive lane still decodes (its logits
            are computed) but its rows, state and length stay as they
            were, as the reference's adapter selects them.

    Returns (cache, logits (B, vocab_padded) float32)."""
    lm.check_supported(cfg)
    quant = quantized(cfg)
    B = tokens.shape[0]
    pos = cache["len"].to(torch.int32).expand(B)
    x = lm.embed_tick(cfg, params, tokens, pos)            # (B, 1, d)
    for i, (lp, window, moe_layer, cross) in enumerate(
            lm.layers(cfg, params)):
        if cfg.family == "rwkv":
            x, st = lm.rwkv_block(cfg, lp, x,
                                  {key: cache[key][i] for key in RWKV_KEYS})
            for key in RWKV_KEYS:
                _put(cache[key][i], st[key], active)
            continue
        z = lm._norm_apply(cfg, lp["ln1"], x)
        att = lm.attn_decode(cfg, lp["attn"], z, cache["k"][i],
                             cache["v"][i], pos, window=window,
                             active=active,
                             scales=tuple(cache[key][i] for key in SCALE_KEYS)
                             if quant else None)
        x = _block_tail(cfg, lp, x, z, att, moe_layer, cache, i, cross,
                        active)
    cache["len"] += 1 if active is None else active.to(cache["len"].dtype)
    return cache, lm.logits(cfg, params, x)[:, 0]


def decode_step_paged(cfg: lm.LMConfig, params: dict, tokens: torch.Tensor,
                      *, tables: torch.Tensor, lens: torch.Tensor,
                      arena: dict, wbids: torch.Tensor | None = None,
                      backend: str = "plain", cascade: dict | None = None,
                      state: dict | None = None,
                      active: torch.Tensor | None = None) -> torch.Tensor:
    """One batched decode tick reading K/V in place from the block arena.

    tokens  (S, 1) int32, one per slot lane.
    tables  (S, nb) int32 arena block ids (trash-padded past each chain).
    lens    (S,) int32 lengths; the new token lands at position ``lens``.
    arena   :func:`init_paged_arena` dict, **updated in place**: one K and
            one V row per layer and lane at (``wbids``, ``lens % bs``);
            under :func:`quantized` int8 rows and their float32 scale rows
            in k_scale / v_scale, written by the plain row write (the
            reference's is XLA), and ``backend`` must be ``"plain"``.  Or
            the :func:`shard_arena` list of a slice's shards: each layer's
            attention runs once per shard
            (:func:`repro_torch.nn.attention.attend_decode_shards`), the
            outputs joined in head order on the first shard's device (where
            everything else runs) before the output projection, and each
            shard writes its heads of the rows, or under the split-KV
            fallback the rows of the lanes whose position it holds (the
            other lanes write its trash block).
    wbids   (S,) int32 block each lane's row lands in; the caller routes
            lanes that must not write to the trash block 0.  ``None``
            derives it from the table, routing lanes past the table to 0.
    backend ``"plain"`` (gather + masked softmax, indexed write),
            ``"cuda"`` (the ``paged_decode_attention`` kernel in every
            layer and one ``scatter_kv_rows`` launch after the layer loop,
            from the layers' rows; not for the vlm family)
            or ``"cascade"`` (shared-prefix cascade attention in every
            layer from the group metadata ``cascade``, see
            :func:`repro_torch.nn.attention.attend_decode_cascade`; the
            same write as ``"cuda"``, whose wrapper runs the plain write
            for CPU tensors; not for the vlm family, whose tick is
            ``"plain"``, as the reference's is XLA).
    state   the lanes' state (:func:`init_state` with S lanes): the
            hybrid family's conv (L, S, K-1, d_inner) and ssm (L, S,
            d_inner, N), **updated in place**, ``active`` (S,) bool
            keeping an inactive lane's as it was, as the reference's
            adapter selects it; the encdec and vlm families' cross K/V xk /
            xv (n_cross, S, cross_len, Hkv, Dh), read only.  The decoder
            and moe families have no slot state besides ``lens`` (the
            caller's).

    Returns the logits (S, vocab_padded) float32."""
    lm.check_supported(cfg)
    _refuse_rwkv(cfg, "the paged tick")
    if backend not in ("plain", "cuda", "cascade"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if cfg.family == "vlm" and backend != "plain":
        raise ValueError(f"backend={backend!r}: the vlm family's tick runs "
                         "the plain read only, as the reference's runs XLA "
                         "only")
    quant = quantized(cfg)
    if quant and backend != "plain":
        raise ValueError(f"backend={backend!r}: the int8 kv_quant layout's "
                         "tick runs the plain read only, as the reference's "
                         "runs XLA only")
    if (cfg.family == "hybrid" or cfg.n_cross) and state is None:
        raise ValueError(f"the {cfg.family} family's tick needs the "
                         "lanes' state (state=)")
    sharded = isinstance(arena, (list, tuple))
    bs = arena[-1].positions[1] if sharded else arena["k"].shape[-3]
    nb = tables.shape[1]
    pos = lens.to(torch.int32)
    offs = pos % bs
    if wbids is None:
        blk = tables.gather(1, (pos // bs).clamp(max=nb - 1).long()[:, None])
        wbids = torch.where(pos >= nb * bs, 0, blk[:, 0])
    x = lm.embed_tick(cfg, params, tokens, pos)            # (S, 1, d)
    keys = PAGED_SEQ_KEYS if quant else ("k", "v")
    rows = {key: [] for key in keys}
    for i, (lp, window, moe_layer, cross) in enumerate(
            lm.layers(cfg, params)):
        z = lm._norm_apply(cfg, lp["ln1"], x)
        if sharded:
            att, *new = lm.attn_decode_paged(
                cfg, lp["attn"], z, None, None, tables, pos, window=window,
                backend=backend, cascade=cascade,
                shards=layer_shards(arena, i, quant))
        else:
            att, *new = lm.attn_decode_paged(
                cfg, lp["attn"], z, arena["k"][i], arena["v"][i], tables,
                pos, window=window, backend=backend, cascade=cascade,
                scales=tuple(arena[key][i] for key in SCALE_KEYS)
                if quant else None)
        x = _block_tail(cfg, lp, x, z, att, moe_layer, state, i, cross,
                        active)
        for key, r in zip(keys, new):
            rows[key].append(r)
    # the tick's only sequence-axis write: one (S, Hkv, Dh) row per layer
    # (and under kv_quant one (S, Hkv, 1) scale row per layer), landed
    # after the layer loop so every layer read the arena as it was; the
    # kernel takes the layers' rows where they lie (no stacked copy)
    wbids, offs = wbids.to(torch.int32), offs.to(torch.int32)
    scatter = ref.scatter_kv_rows if backend == "plain" else \
        paged_kernels.scatter_kv_rows
    if sharded:
        _scatter_shards(scatter, arena, rows, keys, wbids, offs)
    else:
        for kk, vk in zip(keys[::2], keys[1::2]):
            scatter(arena[kk], arena[vk], rows[kk], rows[vk], wbids, offs)
    return lm.logits(cfg, params, x)[:, 0]


def _scatter_shards(scatter, shards: list[ArenaShard], rows: dict,
                    keys: tuple, wbids: torch.Tensor,
                    offs: torch.Tensor) -> None:
    """The sharded tick's row write, one launch per shard and key pair: a
    head split writes each shard's heads of every lane's rows; under the
    split-KV fallback each shard writes the full rows of the lanes whose
    in-block offset it holds, at the offset within its positions, and
    routes the other lanes to its trash block."""
    heads = shard_axis(shards) == -2
    if heads:
        rows = {key: torch.stack(rs) for key, rs in rows.items()}
    for sh in shards:
        dev, (p0, p1), (h0, h1) = sh.device, sh.positions, sh.heads
        held = (offs >= p0) & (offs < p1)
        wb = torch.where(held, wbids, 0).to(dev)
        of = torch.where(held, offs - p0, 0).to(dev)
        for kk, vk in zip(keys[::2], keys[1::2]):
            if heads:
                rk, rv = (rows[key][:, :, h0:h1].contiguous().to(dev)
                          for key in (kk, vk))
            else:
                rk, rv = ([r.to(dev) for r in rows[key]] for key in (kk, vk))
            scatter(sh.arrays[kk], sh.arrays[vk], rk, rv, wb, of)
