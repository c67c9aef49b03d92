"""The LM decoder family (llama-style pre-norm blocks, RoPE, SwiGLU) for
inference in PyTorch: configuration, parameters, the SC frontend, prefill
blocks and the single-token decode attention, dense and paged.

The public layout is the reference's: parameters are a nested dict of
tensors with the per-layer ones stacked on a leading layer axis
(``params["blocks"]["attn"]["wq"]`` is (L, d, Hq*Dh)), dense weights are
(in, out), activations (B, S, d).  Layers run as a Python loop over that
axis.  Only the decoder family is ported; the other families and the int8
KV cache come in later slices (ROADMAP.md).

``first_layer_mode="sc"`` puts the paper's SC layer in front of the blocks
as a residual projection (:func:`sc_frontend`), on the prompt's tokens
only: the decode ticks embed their token without it, as the reference's
do (``serve/engine.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import sc_layer
from repro_torch.nn import attention, mlp as mlp_lib, norms, rope

_GLOBAL_WINDOW = 1 << 30       # a "window" so large it never masks


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields that the decoder family reads."""
    name: str = "lm"
    family: str = "decoder"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    mlp_type: str = "swiglu"          # "swiglu" only, so far
    use_bias: bool = False
    rope_theta: float = 500000.0
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: int = 0                   # sliding-window size (0 = full attn)
    global_every: int = 0             # every k-th layer is full attention
    param_dtype: str = "bfloat16"     # "bfloat16" | "float32"
    q_chunk: int = 512
    kv_chunk: int = 1024
    first_layer_mode: str = "none"    # "none" | "sc" (the SC frontend)
    sc_bits: int = 4

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128

    def is_global_layer(self, idx: int) -> bool:
        if self.window == 0:
            return True
        if self.global_every == 0:
            return False
        return idx % self.global_every == 0


def check_supported(cfg: LMConfig) -> None:
    """Raise for what this slice of the port does not cover."""
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md §1, "
            "the other families")
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r}: only swiglu "
                                  "is ported (decoder family)")


def layer_window(cfg: LMConfig, idx: int) -> int:
    """Per-layer effective window: 0 if the arch has no windowing, else the
    sliding window or, on a global-attention layer, a huge one."""
    if cfg.window == 0:
        return 0
    return _GLOBAL_WINDOW if cfg.is_global_layer(idx) else cfg.window


# ==========================================================================
# Parameters.
# ==========================================================================

def _dense(gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
           scale: float | None = None) -> torch.Tensor:
    """``scale`` (default 1/sqrt(fan_in)) times a standard normal truncated
    at +-2, drawn in float32 on the generator's device, then cast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def _attn_params(gen, cfg: LMConfig, L: int) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {nm: _dense(gen, (L,) + shape, cfg.dtype)
         for nm, shape in (("wq", (d, hq * dh)), ("wk", (d, hkv * dh)),
                           ("wv", (d, hkv * dh)), ("wo", (hq * dh, d)))}
    if cfg.use_bias:
        for nm, width in (("bq", hq * dh), ("bv", hkv * dh), ("bo", d)):
            p[nm] = torch.zeros((L, width), dtype=cfg.dtype,
                                device=gen.device)
    return p


def _mlp_params(gen, cfg: LMConfig, L: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {nm: _dense(gen, (L,) + shape, cfg.dtype)
            for nm, shape in (("w_gate", (d, f)), ("w_in", (d, f)),
                              ("w_out", (f, d)))}


def _norm_params(cfg: LMConfig, lead: tuple[int, ...], device) -> dict:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=cfg.dtype,
                             device=device)}
    if cfg.use_bias:
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=cfg.dtype,
                                device=device)
    return p


def init(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random decoder-family parameters, drawn from ``gen`` on its device
    in the reference's order and layout.  They are not the reference's
    numbers for any seed; ``repro_torch.convert.lm_params_from_jax`` shares
    the reference's weights instead."""
    check_supported(cfg)
    dev, L, d, V = gen.device, cfg.n_layers, cfg.d_model, cfg.vocab_padded
    p: dict = {"embed": _dense(gen, (V, d), cfg.dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense(gen, (d, V), cfg.dtype)
    p["final_norm"] = _norm_params(cfg, (), dev)
    if cfg.first_layer_mode == "sc":
        p["sc_frontend"] = {"w": _dense(gen, (d, d), cfg.dtype),
                            "gamma": torch.ones((d,), dtype=cfg.dtype,
                                                device=dev)}
    p["blocks"] = {"ln1": _norm_params(cfg, (L,), dev),
                   "attn": _attn_params(gen, cfg, L),
                   "ln2": _norm_params(cfg, (L,), dev),
                   "mlp": _mlp_params(gen, cfg, L)}
    return p


def layer_params(params: dict, idx: int) -> dict:
    """Layer ``idx`` of the stacked ``params["blocks"]`` (views)."""
    return {k: layer_params(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in params.items()}


# ==========================================================================
# Blocks (forward).
# ==========================================================================

def _norm_apply(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm" or "bias" in p:
        return norms.layernorm(x, p["scale"], p.get("bias", 0.0),
                               cfg.norm_eps)
    return norms.rmsnorm(x, p["scale"], cfg.norm_eps)


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
          ) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


def _mlp_apply(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_lib.swiglu(x, p["w_gate"], p["w_in"], p["w_out"])


def _attn_apply(cfg: LMConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                window: int = 0, q_offset: int = 0,
                kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)) with k, v
    the post-RoPE (B, S, Hkv, Dh) cache rows.  A sliding window is applied
    as a mask through ``attend_chunked``.

    ``kv_prefix``: the post-RoPE (k, v) of a cache prefix of ``q_offset``
    positions (one chunk of the prefill fold).  Queries come from ``x`` at
    the absolute ``positions``, keys are the prefix followed by the chunk,
    and the returned (k, v) cover prefix and chunk.  A layer whose static
    window is shorter than the prefix attends only the prefix's last
    ``window`` rows, with the offset shifted to match, as in the
    reference."""
    B, S, _ = x.shape
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = _proj(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, cfg.n_kv_heads,
                                               cfg.d_head)
    q = rope.apply_rope(q, positions, cfg.rope_theta)
    k = rope.apply_rope(k, positions, cfg.rope_theta)
    cut = 0                 # leading key rows attention does not read
    if kv_prefix is not None:
        pk, pv = kv_prefix
        if pk.shape[1] != q_offset:
            raise ValueError(f"kv_prefix holds {pk.shape[1]} positions, "
                             f"q_offset is {q_offset}")
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)
        if 0 < window < q_offset and causal:
            cut = q_offset - window
    o = attention.attend_chunked(q, k[:, cut:].contiguous(),
                                 v[:, cut:].contiguous(), causal=causal,
                                 window=window, q_offset=q_offset - cut,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = _proj(o.reshape(B, S, cfg.n_heads * cfg.d_head), p["wo"],
                p.get("bo"))
    return out, (k, v)


def attn_decode_paged(cfg: LMConfig, p: dict, x1: torch.Tensor,
                      k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                      tables: torch.Tensor, pos: torch.Tensor, *,
                      window: int = 0, backend: str = "plain",
                      cascade: dict | None = None):
    """One-token decode attention for a batch of slot lanes, reading K/V in
    place from one layer's slice of the paged block arena.

    x1: (S, 1, d) normed activations; k_blocks, v_blocks: (num_blocks, 1,
    bs, Hkv, Dh), one layer of ``engine.init_paged_arena``; tables: (S, nb)
    int32; pos: (S,) int32 lengths (the new token's row index).  Returns
    (out (S, 1, d), k1, v1), k1/v1 the (S, Hkv, Dh) post-RoPE rows the
    caller writes into the arena after the layer loop; attention reads them
    at ``pos`` in place of the arena's row (``backend`` "plain", "cuda" or
    "cascade" with the group metadata ``cascade``, see
    :func:`repro_torch.nn.attention.attend_decode_paged`)."""
    B = x1.shape[0]
    q = _proj(x1, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k1 = _proj(x1, p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v1 = _proj(x1, p["wv"], p.get("bv")).reshape(B, 1, cfg.n_kv_heads,
                                                 cfg.d_head)
    posb = pos[:, None]
    q = rope.apply_rope(q, posb, cfg.rope_theta)
    k1 = rope.apply_rope(k1, posb, cfg.rope_theta)
    k1, v1 = k1[:, 0].contiguous(), v1[:, 0].contiguous()
    o = attention.attend_decode_paged(q, k_blocks[:, 0], v_blocks[:, 0],
                                      tables, pos + 1, window=window,
                                      new_kv=(k1, v1), backend=backend,
                                      cascade=cascade)
    out = _proj(o.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"],
                p.get("bo"))
    return out, k1, v1


def attn_decode(cfg: LMConfig, p: dict, x1: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, *, window: int = 0,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """One-token decode attention for a batch of lanes against one layer
    of the dense cache, each lane at its own position.

    x1: (B, 1, d) normed activations; cache_k, cache_v: (B, Smax, Hkv, Dh),
    **updated in place**; pos: (B,) int32 lengths (the new token's row).
    Each lane's post-RoPE K/V row lands at ``pos`` (clamped to Smax - 1,
    where the reference's ``dynamic_update_slice`` clamps it) and attention
    reads ``pos + 1`` positions.  With ``active`` (B,) bool, an inactive
    lane's row is put back as it was after the read: the cache is then
    bitwise the reference's masked tick, which selects every inactive
    lane's old cache.  Returns (B, 1, d)."""
    B = x1.shape[0]
    q = _proj(x1, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k1 = _proj(x1, p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v1 = _proj(x1, p["wv"], p.get("bv")).reshape(B, 1, cfg.n_kv_heads,
                                                 cfg.d_head)
    posb = pos[:, None]
    q = rope.apply_rope(q, posb, cfg.rope_theta)
    k1 = rope.apply_rope(k1, posb, cfg.rope_theta)
    lanes = torch.arange(B, device=x1.device)
    at = pos.clamp(max=cache_k.shape[1] - 1).long()
    kept = None if active is None else \
        (cache_k[lanes, at].clone(), cache_v[lanes, at].clone())
    cache_k[lanes, at] = k1[:, 0].to(cache_k.dtype)
    cache_v[lanes, at] = v1[:, 0].to(cache_v.dtype)
    o = attention.attend_decode(q, cache_k, cache_v, pos + 1, window=window)
    if kept is not None:
        keep = active[:, None, None]
        cache_k[lanes, at] = torch.where(keep, cache_k[lanes, at], kept[0])
        cache_v[lanes, at] = torch.where(keep, cache_v[lanes, at], kept[1])
    return _proj(o.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"],
                 p.get("bo"))


def decoder_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  q_offset: int = 0, causal: bool = True,
                  kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Pre-norm transformer block.  Returns (x, (k, v)); with
    ``kv_prefix`` (a chunk of the prefill fold, see :func:`_attn_apply`)
    k, v span prefix and chunk."""
    h, kv = _attn_apply(cfg, p["attn"], _norm_apply(cfg, p["ln1"], x),
                        positions, causal=causal, window=window,
                        q_offset=q_offset, kv_prefix=kv_prefix)
    x = x + h
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x)), kv


def sc_frontend(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The paper's SC layer as the LM's first projection: each token's
    activations normalized into [0, 1] (per vector, with the reference's
    1e-6 floor, in x's dtype, then float32), the split-weight SC dot
    product and sign against ``p["w"]`` (d, d) at ``cfg.sc_bits``
    (``core.sc_layer.sc_dot_sign``: ``sng_pack`` and ``sc_dot`` on a CUDA
    tensor), with a straight-through estimator (forward the SC output,
    backward the linear surrogate ``x01 @ w``), scaled by ``p["gamma"]``.
    x (B, S, d) -> (B, S, d) in x's dtype."""
    lo = x.amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    x01 = ((x - lo) / torch.clamp(hi - lo, min=1e-6)).to(torch.float32)
    w = p["w"].to(torch.float32)
    sc_out = sc_layer.sc_dot_sign(x01, w, sc_layer.SCConfig(bits=cfg.sc_bits))
    lin = torch.einsum("bsd,df->bsf", x01, w)
    out = (sc_out - lin).detach() + lin
    return (out * p["gamma"].to(torch.float32)).to(x.dtype)


def token_rows(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: what a decode tick embeds (the
    reference's ticks index ``params["embed"]`` and skip the SC
    frontend)."""
    return params["embed"][tokens.long()]


def embed_tokens(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                 pos_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) integer -> (B, S, d) embedding rows, plus the SC
    frontend's output under ``first_layer_mode="sc"`` (a residual insert).
    ``pos_offset`` is the absolute position of tokens[:, 0]; the decoder
    family encodes positions by RoPE inside attention, so its embedding
    does not read it (the reference's sinusoidal families do)."""
    check_supported(cfg)
    x = token_rows(params, tokens)
    if cfg.first_layer_mode == "sc":
        x = x + sc_frontend(cfg, params["sc_frontend"], x)
    return x


def logits(cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection, float32 over
    ``vocab_padded`` columns (the reference's
    ``preferred_element_type=float32``: bf16 operands are widened, so
    products are exact and the sum is float32)."""
    x = _norm_apply(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float()
