"""The LM decoder, moe, hybrid, encdec, vlm and rwkv families (llama-style
pre-norm blocks, RoPE, SwiGLU; the moe family a dense layer 0 and
routed-expert FFNs after it; the hybrid family hymba's parallel GQA
attention and Mamba heads per block, sliding windows with periodic global
layers; the encdec family whisper's non-causal encoder over frame
embeddings and a decoder of causal self-attention, gated cross-attention
and a GELU MLP, with biases, LayerNorm and sinusoidal positions; the vlm
family llama-3.2-vision's decoder with a gated cross-attention layer over
vision tokens every ``cross_every``-th layer; the rwkv family RWKV6's
attention-free time mix and channel mix) in PyTorch: configuration,
parameters, the SC frontend, prefill blocks, the single-token decode
attention, dense and paged, and the training forward (:func:`forward`).

The public layout is the reference's: parameters are a nested dict of
tensors with the per-layer ones stacked on a leading layer axis
(``params["blocks"]["attn"]["wq"]`` is (L, d, Hq*Dh)), dense weights are
(in, out), activations (B, S, d).  The moe family keeps its dense layer 0
in ``params["dense0"]`` (a leading axis of 1) and its ``n_layers - 1``
MoE blocks in ``params["blocks"]`` (``"moe"`` in place of ``"mlp"``).
The hybrid family's blocks add the SSM branch's weights beside
``"attn"`` and ``"mlp"`` (:func:`_hymba_params`) and carry a recurrent
state per layer, the conv taps (B, K-1, d_inner) in the model's dtype and
the SSM state (B, d_inner, N) in float32 (:func:`hymba_block`).  Layers
run as a Python loop (:func:`layers`) with static per-layer windows; the
reference's grouped scan layout (``hybrid_grouped``) computes the same
function.  The encdec family keeps its encoder in ``params["enc_blocks"]``
and ``params["enc_norm"]`` and its decoder in ``params["dec_blocks"]``
(``"ln_x"``, ``"xattn"`` and ``"gate_attn"`` beside a decoder block's
weights; :func:`cross_block`); its frontend is a stub, as in the
reference: the caller hands over frame embeddings.  The vlm family keeps
its ``n_layers - G`` self layers in ``params["blocks"]`` and its G =
``n_layers / cross_every`` cross layers in ``params["cross_blocks"]`` (a
decoder block with ``"ln_x"``, ``"xattn"`` and a ``"gate_attn"`` of 0
beside it); group g runs self blocks ``g (k - 1)`` to ``g (k - 1) + k - 2``,
then cross block g (:func:`layers`).  Its vision tower is a stub, as in
the reference: the caller hands over patch embeddings.  The rwkv family's
blocks hold the token-shift mixes ``mu`` (L, 7, d), the r / k / v / g
projections, ``wo``, the LoRA decay (``w0``, ``w_lora_a``, ``w_lora_b``),
the bonus ``u`` (L, H, Dh), the wkv output's norm ``ln_wkv`` and the
channel mix (``cm_k``, ``cm_v``, ``cm_r``) (:func:`_rwkv_params`), and
carry a recurrent state per layer, the wkv state (B, H, Dh, Dh) in float32
and the two token-shift rows (B, d) in the model's dtype
(:func:`rwkv_block`).  ``kv_quant`` stores the decoder, moe and hybrid
families' K/V int8 with a float32 scale per (token, head)
(``serve/kvquant.py``): the decode attentions take the layer's scales
(``scales=``), quantize the new row and read the dequantized cache.

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
from repro_torch.nn import attention, mlp as mlp_lib, moe as moe_lib
from repro_torch.nn import norms, rope, ssm
from repro_torch.serve import kvquant

_GLOBAL_WINDOW = 1 << 30       # a "window" so large it never masks
FAMILIES = ("decoder", "moe", "rwkv", "hybrid", "encdec", "vlm")
RWKV_LORA = 64                 # the rank of the rwkv family's decay LoRA


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields that the decoder, moe, hybrid,
    encdec, vlm and rwkv families read."""
    name: str = "lm"
    family: str = "decoder"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    mlp_type: str = "swiglu"          # "swiglu" | "gelu"
    use_bias: bool = False            # whisper-style biases
    rope_theta: float = 500000.0
    pos_embedding: str = "rope"       # "rope" | "sinusoidal"
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    first_dense_ff: int = 0           # layer-0 dense FFN width (moe family)
    moe_group_size: int = 2048
    moe_impl: str = "einsum"
    capacity_factor: float = 1.25
    # serving prefill routes dropless (see decoder_block): required for
    # prefix-cache resumption; off by default, as in the reference
    moe_dropless_prefill: bool = False
    # --- vlm ---
    cross_every: int = 0              # a cross-attn layer every k layers
    n_vision_tokens: int = 1024
    # --- encdec ---
    enc_layers: int = 0
    enc_len: int = 1500               # encoder frames (cross-attention keys)
    # --- hybrid / ssm ---
    ssm_state: int = 0
    d_inner: int = 0                  # mamba inner width (2*d_model default)
    dt_rank: int = 0                  # 0: max(16, d_model // 16)
    conv_k: int = 4
    window: int = 0                   # sliding-window size (0 = full attn)
    global_every: int = 0             # every k-th layer is full attention
    param_dtype: str = "bfloat16"     # "bfloat16" | "float32"
    # the training forward's recomputation per layer: "none" | "full" |
    # "dots" (keep the matrix products' outputs), as the reference
    remat: str = "full"
    q_chunk: int = 512
    kv_chunk: int = 1024
    rwkv_chunk: int = 16              # the prompt wkv's chunk (rwkv)
    ssm_chunk: int = 32               # the prompt scan's chunk (hybrid)
    loss_chunk: int = 1024            # sequence chunk of the training loss
    first_layer_mode: str = "none"    # "none" | "sc" (the SC frontend)
    sc_bits: int = 4
    # --- serving: int8 KV cache with a float32 scale per (token, head) ---
    kv_quant: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def moe(self) -> moe_lib.MoEConfig | None:
        if self.n_experts == 0:
            return None
        return moe_lib.MoEConfig(self.n_experts, self.top_k, self.d_expert,
                                 self.n_shared, self.capacity_factor,
                                 self.moe_group_size, impl=self.moe_impl)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def n_cross(self) -> int:
        """Cross-attention layers: every decoder layer of the encdec
        family, one per group of ``cross_every`` layers of the vlm family,
        none for the others."""
        if self.family == "encdec":
            return self.n_layers
        if self.family == "vlm":
            return self.n_layers // self.cross_every
        return 0

    @property
    def cross_len(self) -> int:
        """Keys of the cross-attention: the encoder's frames (encdec) or
        the vision tokens (vlm)."""
        return self.n_vision_tokens if self.family == "vlm" else self.enc_len

    def is_global_layer(self, idx: int) -> bool:
        if self.window == 0:
            return True
        if self.global_every == 0:
            return False
        return idx % self.global_every == 0


def check_supported(cfg: LMConfig) -> None:
    """Raise for what the port does not cover, and for a family it does not
    know (``ValueError``, as the reference's ``init`` raises)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (families: "
                         f"{FAMILIES})")
    if cfg.mlp_type not in ("swiglu", "gelu"):
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r}: only swiglu "
                                  "and gelu are ported")
    if cfg.pos_embedding not in ("rope", "sinusoidal"):
        raise NotImplementedError(f"pos_embedding {cfg.pos_embedding!r}")
    if cfg.family == "moe" and cfg.n_experts == 0:
        raise ValueError("the moe family needs n_experts > 0")
    if cfg.family == "hybrid" and cfg.ssm_state == 0:
        raise ValueError("the hybrid family needs ssm_state > 0")
    if cfg.family == "encdec" and cfg.enc_layers == 0:
        raise ValueError("the encdec family needs enc_layers > 0")
    if cfg.family == "vlm" and (cfg.cross_every < 1
                                or cfg.n_layers % cfg.cross_every):
        raise ValueError(f"the vlm family needs n_layers ({cfg.n_layers}) "
                         f"to be a multiple of cross_every "
                         f"({cfg.cross_every}), as the reference asserts")


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
    at +-2, drawn in float32 on the generator's device, then cast.  On the
    meta device (:func:`count_params`) only the shape is made."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: one float32 copy of the tensor at a time, so a
    # stacked weight of many layers draws with room to spare on the card
    return t.mul_(scale).to(dtype)


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


def _mlp_params(gen, cfg: LMConfig, L: int, f: int) -> dict:
    """SwiGLU's ``w_gate``, ``w_in``, ``w_out`` or GELU's ``w_in``,
    ``w_out`` (``cfg.mlp_type``), plus zero ``b_in`` and ``b_out`` for a
    GELU MLP under ``cfg.use_bias``, as the reference's ``_mlp_params``."""
    d = cfg.d_model
    swiglu = cfg.mlp_type == "swiglu"
    names = (("w_gate", (d, f)),) if swiglu else ()
    p = {nm: _dense(gen, (L,) + shape, cfg.dtype)
         for nm, shape in names + (("w_in", (d, f)), ("w_out", (f, d)))}
    if cfg.use_bias and not swiglu:
        for nm, width in (("b_in", f), ("b_out", d)):
            p[nm] = torch.zeros((L, width), dtype=cfg.dtype,
                                device=gen.device)
    return p


def _moe_params(gen, cfg: LMConfig, L: int) -> dict:
    """The reference's MoE weights: the router (L, d, E), the routed
    experts (L, E, d, f) / (L, E, f, d) and the shared experts (L, d,
    n_shared * f) / (L, n_shared * f, d).  The experts are drawn one layer
    at a time (at deepseek-moe-16b's width a layer's float32 draw is 0.74
    GB, the whole stack's 20 GB)."""
    m, d = cfg.moe, cfg.d_model
    f, E = m.d_expert, m.n_experts
    p = {"w_router": _dense(gen, (L, d, E), cfg.dtype)}
    for nm, shape in (("w_gate", (E, d, f)), ("w_in", (E, d, f)),
                      ("w_out", (E, f, d))):
        p[nm] = torch.empty((L,) + shape, dtype=cfg.dtype, device=gen.device)
        for i in range(L):
            p[nm][i] = _dense(gen, shape, cfg.dtype)
    if m.n_shared:
        sf = m.n_shared * f
        for nm, shape in (("shared_gate", (d, sf)), ("shared_in", (d, sf)),
                          ("shared_out", (sf, d))):
            p[nm] = _dense(gen, (L,) + shape, cfg.dtype)
    return p


def _hymba_params(gen, cfg: LMConfig, L: int) -> dict:
    """The reference's hymba block (``_hymba_block_params``), same names,
    shapes, fills and scales: the attention, the SSM branch (``in_proj``
    (d, 2 di), the depthwise ``conv_w`` (K, di) at scale 0.5, ``x_proj``
    (di, dt_rank + 2 N), ``dt_proj`` (dt_rank, di), ``dt_bias`` -4.6,
    ``A_log`` log(1..N) on every row, ``D_skip`` 1, ``ssm_out`` (di, d)),
    the two branch norms, ``beta`` 1 (L, 2) and the SwiGLU MLP."""
    dev = gen.device
    d, di, N = cfg.d_model, cfg.inner, cfg.ssm_state
    dtr = cfg.dt_rank or max(16, d // 16)

    def fill(shape, value):
        return torch.full((L,) + shape, value, dtype=cfg.dtype, device=dev)
    return {"ln1": _norm_params(cfg, (L,), dev),
            "attn": _attn_params(gen, cfg, L),
            "in_proj": _dense(gen, (L, d, 2 * di), cfg.dtype),
            "conv_w": _dense(gen, (L, cfg.conv_k, di), cfg.dtype, scale=0.5),
            "x_proj": _dense(gen, (L, di, dtr + 2 * N), cfg.dtype),
            "dt_proj": _dense(gen, (L, dtr, di), cfg.dtype),
            "dt_bias": fill((di,), -4.6),
            "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                            device=dev)).expand(L, di, N)
            .to(cfg.dtype).contiguous(),
            "D_skip": fill((di,), 1.0),
            "ssm_out": _dense(gen, (L, di, d), cfg.dtype),
            "norm_attn": _norm_params(cfg, (L,), dev),
            "norm_ssm": _norm_params(cfg, (L,), dev),
            "beta": fill((2,), 1.0),
            "ln2": _norm_params(cfg, (L,), dev),
            "mlp": _mlp_params(gen, cfg, L, cfg.d_ff)}


def _rwkv_params(gen, cfg: LMConfig, L: int) -> dict:
    """The reference's rwkv block (``_rwkv_block_params``), same names,
    order, shapes, fills and scales: ``ln1``, ``ln2``, the seven token-shift
    mixes ``mu`` (L, 7, d) at 0.5 (time mix r, k, v, g, w; channel mix k,
    r), ``wr`` / ``wk`` / ``wv`` / ``wg`` (d, H Dh), ``wo``, the decay
    base ``w0`` -6, the decay LoRA ``w_lora_a`` (d, 64) and ``w_lora_b``
    (64, H Dh) at scale 0.01, the bonus ``u`` (H, Dh) at scale 0.3,
    ``ln_wkv`` over H Dh, and the channel mix ``cm_k`` (d, d_ff), ``cm_v``
    (d_ff, d), ``cm_r`` (d, d).  The norms have no bias whatever
    ``use_bias`` is."""
    dev, dt = gen.device, cfg.dtype
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head

    def ones(width):
        return {"scale": torch.ones((L, width), dtype=dt, device=dev)}
    p = {"ln1": ones(d), "ln2": ones(d),
         "mu": torch.full((L, 7, d), 0.5, dtype=dt, device=dev)}
    for nm in ("wr", "wk", "wv", "wg"):
        p[nm] = _dense(gen, (L, d, hd), dt)
    p["wo"] = _dense(gen, (L, hd, d), dt)
    p["w0"] = torch.full((L, hd), -6.0, dtype=dt, device=dev)
    p["w_lora_a"] = _dense(gen, (L, d, RWKV_LORA), dt)
    p["w_lora_b"] = _dense(gen, (L, RWKV_LORA, hd), dt, scale=0.01)
    p["u"] = _dense(gen, (L, cfg.n_heads, cfg.d_head), dt, scale=0.3)
    p["ln_wkv"] = ones(hd)
    p["cm_k"] = _dense(gen, (L, d, cfg.d_ff), dt)
    p["cm_v"] = _dense(gen, (L, cfg.d_ff, d), dt)
    p["cm_r"] = _dense(gen, (L, d, d), dt)
    return p


def _norm_params(cfg: LMConfig, lead: tuple[int, ...], device) -> dict:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=cfg.dtype,
                             device=device)}
    if cfg.use_bias:
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=cfg.dtype,
                                device=device)
    return p


def init(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random decoder-, moe-, rwkv-, hybrid-, encdec- or vlm-family
    parameters,
    drawn from ``gen`` on its device in the reference's order and layout.  They are
    not the reference's numbers for any seed;
    ``repro_torch.convert.lm_params_from_jax`` shares the reference's
    weights instead."""
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

    def block(L: int, moe_layer: bool, ff: int) -> dict:
        b = {"ln1": _norm_params(cfg, (L,), dev),
             "attn": _attn_params(gen, cfg, L),
             "ln2": _norm_params(cfg, (L,), dev)}
        if moe_layer:
            b["moe"] = _moe_params(gen, cfg, L)
        else:
            b["mlp"] = _mlp_params(gen, cfg, L, ff)
        return b

    def cross_blocks(L: int, gate: float) -> dict:
        # a decoder block with the cross-attention's norm, weights and a
        # tanh gate after it (the reference's _cross_block_params)
        return {**block(L, False, cfg.d_ff),
                "ln_x": _norm_params(cfg, (L,), dev),
                "xattn": _attn_params(gen, cfg, L),
                "gate_attn": torch.full((L,), gate, dtype=cfg.dtype,
                                        device=dev)}
    if cfg.family == "moe":
        p["dense0"] = block(1, False, cfg.first_dense_ff or cfg.d_ff)
        p["blocks"] = block(L - 1, True, cfg.d_ff)
    elif cfg.family == "rwkv":
        p["blocks"] = _rwkv_params(gen, cfg, L)
    elif cfg.family == "hybrid":
        p["blocks"] = _hymba_params(gen, cfg, L)
    elif cfg.family == "encdec":
        # the reference's encoder stack and its norm, then its decoder of
        # cross blocks, gates 1
        p["enc_blocks"] = block(cfg.enc_layers, False, cfg.d_ff)
        p["enc_norm"] = _norm_params(cfg, (), dev)
        p["dec_blocks"] = cross_blocks(L, 1.0)
    elif cfg.family == "vlm":
        # the self layers, then one cross block per group, gates 0
        p["blocks"] = block(L - cfg.n_cross, False, cfg.d_ff)
        p["cross_blocks"] = cross_blocks(cfg.n_cross, 0.0)
    else:
        p["blocks"] = block(L, False, cfg.d_ff)
    return p


# the reference's logical axes of each leaf past its layer axis
# (``_attn_params``, ``_mlp_params``, ``_moe_params``,
# ``_rwkv_block_params``, ``_hymba_block_params``, ``init``): "tp" is
# sharded over "model" and "fsdp" over "data", each only where the dim
# divides; a leaf not listed is replicated
_ATTN_LOGICAL = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
                 "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp"),
                 "bq": ("tp",), "bv": ("tp",)}
_MLP_LOGICAL = {"w_gate": ("fsdp", "tp"), "w_in": ("fsdp", "tp"),
                "w_out": ("tp", "fsdp"), "b_in": ("tp",)}
_MOE_LOGICAL = {"w_gate": ("tp", "fsdp", None), "w_in": ("tp", "fsdp", None),
                "w_out": ("tp", None, "fsdp"), "shared_gate": ("fsdp", "tp"),
                "shared_in": ("fsdp", "tp"), "shared_out": ("tp", "fsdp")}
_BLOCK_LOGICAL = {
    # rwkv
    "wr": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp"), "w_lora_b": (None, "tp"),
    "cm_k": ("fsdp", "tp"), "cm_v": ("tp", "fsdp"), "cm_r": ("fsdp", None),
    # hybrid
    "in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"), "x_proj": ("tp", None),
    "dt_proj": (None, "tp"), "dt_bias": ("tp",), "A_log": ("tp", None),
    "D_skip": ("tp",), "ssm_out": ("tp", "fsdp")}
_TOP_LOGICAL = {"embed": ("tp", None), "lm_head": ("fsdp", "tp")}
_GROUP_LOGICAL = {"attn": _ATTN_LOGICAL, "xattn": _ATTN_LOGICAL,
                  "mlp": _MLP_LOGICAL, "moe": _MOE_LOGICAL}
# the stacked block groups (a leading layer axis on every leaf)
STACKS = ("blocks", "dense0", "enc_blocks", "dec_blocks", "cross_blocks")


def _shapes(cfg: LMConfig) -> dict:
    """The parameter tree of ``cfg`` on the meta device (shapes only)."""
    return init(cfg, _MetaGenerator())


def param_specs(cfg: LMConfig, mesh_shape: dict[str, int]) -> dict:
    """The parameters' partition specs on a mesh of ``mesh_shape``: the
    reference's ``init(key, cfg, mesh_shape)[1]`` (``_Builder.spec``) for
    the port's parameter tree.  ``"fsdp"`` dims go to ``"data"`` only
    (never ``"pod"``), the embedding is ``"tp"`` on the vocabulary only."""
    from repro_torch.dist.sharding import P
    ms = mesh_shape or {}

    def spec(shape, logical):
        out = []
        for dim, kind in zip(shape, logical):
            if kind == "tp" and dim % ms.get("model", 1) == 0:
                out.append("model")
            elif kind == "fsdp" and dim % ms.get("data", 1) == 0:
                out.append("data")
            else:
                out.append(None)
        return P(*out)

    def walk(tree, table, lead):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, _GROUP_LOGICAL.get(k, {}), lead)
            else:
                logical = table.get(k, (None,) * (v.dim() - lead))
                out[k] = spec(v.shape, (None,) * lead + tuple(logical))
        return out
    tree = _shapes(cfg)
    return {k: walk(v, _BLOCK_LOGICAL, 1) if k in STACKS else
            walk(v, {}, 0) if isinstance(v, dict) else
            spec(v.shape, _TOP_LOGICAL.get(k, (None,) * v.dim()))
            for k, v in tree.items()}


class Blocks:
    """A leaf split over the ``"model"`` axis for tensor parallelism:
    ``parts[j]``, model shard j's contiguous block along ``dim``, on that
    shard's device (``train/step.py`` builds them, :func:`_attn_apply` and
    :func:`_mlp_apply` read them)."""

    def __init__(self, parts: list, dim: int):
        self.parts, self.dim = list(parts), dim

    def unbind(self) -> list["Blocks"]:
        """One :class:`Blocks` a layer of a stacked leaf."""
        per = [torch.unbind(t) for t in self.parts]
        return [Blocks([u[i] for u in per], self.dim - 1)
                for i in range(len(per[0]))]


# the leaves a tensor-parallel attention or MLP splits, by the dim past
# the layer axis that each splits (-1 columns, -2 rows); the others of
# the group (``bo``, ``b_out``) are added once, whole
_TP_ATTN = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bv": -1, "wo": -2}
_TP_MLP = {"w_gate": -1, "w_in": -1, "b_in": -1, "w_out": -2}


def tp_plan(cfg: LMConfig, mesh_shape: dict[str, int]) -> tuple[dict, dict]:
    """Which leaves tensor parallelism over ``"model"`` splits: (a tree
    like the parameters' holding, per leaf, the dim its model shards cut
    or None for a leaf used whole on a group's first device, and the
    layers counted by kind: ``attention_split`` / ``attention_gathered``,
    ``mlp_split`` / ``mlp_gathered``).  A self-attention splits by KV
    heads when ``n_heads`` and ``n_kv_heads`` divide by the model size,
    a dense MLP by its hidden width when that divides; otherwise the
    layer runs unsplit on its leaves gathered whole (where GSPMD would
    reshard).  Cross-attention (its K/V come from the encoder's or vision
    tokens), the MoE experts, the SSM and rwkv mixes always run whole."""
    m = (mesh_shape or {}).get("model", 1)
    heads = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    counts = dict.fromkeys(("attention_split", "attention_gathered",
                            "mlp_split", "mlp_gathered"), 0)

    def group(tree, rule, ok):
        return {k: (v.dim() + rule[k]) if ok and k in rule else None
                for k, v in tree.items()}

    def walk(tree, stacked):
        out = {}
        for k, v in tree.items():
            if not isinstance(v, dict):
                out[k] = None
                continue
            L = _first_leaf(v).shape[0] if stacked else 0
            if stacked and k == "attn" and m > 1:
                counts["attention_split" if heads else
                       "attention_gathered"] += L
                out[k] = group(v, _TP_ATTN, heads)
            elif stacked and k == "mlp" and m > 1:
                ok = v["w_in"].shape[-1] % m == 0
                counts["mlp_split" if ok else "mlp_gathered"] += L
                out[k] = group(v, _TP_MLP, ok)
            else:
                out[k] = walk(v, stacked)
        return out
    tree = _shapes(cfg)
    plan = {k: walk(v, k in STACKS) if isinstance(v, dict) else None
            for k, v in tree.items()}
    return plan, counts


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) \
        if isinstance(tree, dict) else tree


def layer_params(params: dict, idx: int) -> dict:
    """Layer ``idx`` of the stacked ``params["blocks"]`` (views)."""
    return {k: layer_params(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in params.items()}


def layers(cfg: LMConfig, params: dict):
    """The blocks in order, each as (its parameters, its window, whether
    its FFN is the MoE one, its index into the lanes' cross K/V ``xk`` /
    ``xv`` or None for a block without cross-attention); the cache's layer
    axis follows this order.  The moe family runs ``params["dense0"]``
    first, with no window, then its ``n_layers - 1`` MoE blocks, whose
    windows count from 0 at the first MoE block (the reference's scan
    index, not the absolute layer).  The encdec family yields its decoder
    blocks (``params["dec_blocks"]``), block i reading cross K/V i; its
    encoder runs in ``serve.engine.encode_cross``.  The vlm family yields,
    for each group g of ``cross_every`` = k layers, the self blocks
    ``params["blocks"][g (k - 1) + j]`` (j < k - 1), then
    ``params["cross_blocks"][g]``, reading cross K/V g: layer g k + j is
    the reference's grouped ``k[g, j]``, layer g k + k - 1 its
    ``kx_self[g]``."""
    if cfg.family == "encdec":
        for i in range(cfg.n_layers):
            yield layer_params(params["dec_blocks"], i), 0, False, i
        return
    if cfg.family == "vlm":
        k = cfg.cross_every
        for g in range(cfg.n_cross):
            for j in range(k - 1):
                yield layer_params(params["blocks"], g * (k - 1) + j), 0, \
                    False, None
            yield layer_params(params["cross_blocks"], g), 0, False, g
        return
    if cfg.family == "moe":
        yield layer_params(params["dense0"], 0), 0, False, None
        for i in range(cfg.n_layers - 1):
            yield layer_params(params["blocks"], i), layer_window(cfg, i), \
                True, None
    else:
        for i in range(cfg.n_layers):
            yield layer_params(params["blocks"], i), layer_window(cfg, i), \
                False, None


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
    """SwiGLU where the block has ``w_gate``, else the GELU MLP (with its
    biases where it has them), as the reference picks.  With
    :class:`Blocks` leaves (tensor parallelism), model shard j computes
    its columns of ``w_gate`` / ``w_in`` / ``b_in`` and its rows of
    ``w_out`` on its device, a partial output; the partials are added in
    shard order on x's device, then ``b_out`` once."""
    if isinstance(p["w_in"], Blocks):
        out = None
        for pj in _shard_leaves(p, "b_out"):
            part = _mlp_apply(cfg, pj, x.to(pj["w_in"].device)).to(x.device)
            out = part if out is None else out + part
        return out if p.get("b_out") is None else out + p["b_out"]
    if "w_gate" in p:
        return mlp_lib.swiglu(x, p["w_gate"], p["w_in"], p["w_out"])
    return mlp_lib.gelu_mlp(x, p["w_in"], p.get("b_in"), p["w_out"],
                            p.get("b_out"))


def _shard_leaves(p: dict, whole: str) -> list[dict]:
    """Model shard j's leaves of a tensor-parallel group, one dict a
    shard: its block of each :class:`Blocks` leaf and every other leaf but
    ``whole`` (the bias the caller adds once)."""
    m = len(next(v for v in p.values() if isinstance(v, Blocks)).parts)
    return [{k: v.parts[j] if isinstance(v, Blocks) else v
             for k, v in p.items() if k != whole} for j in range(m)]


def moe_ffn_decode(cfg: LMConfig, moe_params: dict, z: torch.Tensor
                   ) -> torch.Tensor:
    """MoE FFN for a (B, 1, d) decode activation, each lane its own
    dispatch group of one token (C = max(top_k, ...) = top_k, so nothing
    drops): the reference's ticks vmap its ``moe_ffn_decode`` over B=1
    lanes, so a lane's output never depends on the other lanes."""
    m = dataclasses.replace(cfg.moe, group_size=1)
    return moe_lib.moe_ffn(z, moe_params, m)[0]


def ffn_decode(cfg: LMConfig, p: dict, z: torch.Tensor, moe_layer: bool
               ) -> torch.Tensor:
    """A block's FFN on a decode tick's (B, 1, d) activation."""
    if moe_layer:
        return moe_ffn_decode(cfg, p["moe"], z)
    return _mlp_apply(cfg, p["mlp"], z)


def _attn_apply(cfg: LMConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                window: int = 0, q_offset: int = 0,
                kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None,
                kv_override: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)) with k, v
    the (B, S, Hkv, Dh) cache rows, post-RoPE where ``cfg.pos_embedding``
    is ``"rope"``.

    ``kv_prefix``: the (k, v) of a cache prefix of ``q_offset`` positions
    (one chunk of the prefill fold).  Queries come from ``x`` at the
    absolute ``positions``, keys are the prefix followed by the chunk, and
    the returned (k, v) cover prefix and chunk.  A layer whose static
    window is shorter than the prefix attends only the prefix's last
    ``window`` rows, with the offset shifted to match, as in the
    reference.

    ``kv_override``: the (k, v) to attend instead of projecting ``x``'s
    (the encdec decoder's cross-attention over the encoder's K/V); RoPE
    then goes on the queries only, and only when causal, as in the
    reference.

    With :class:`Blocks` leaves (tensor parallelism, training only: no
    prefix, no override), model shard j computes its contiguous run of
    KV heads and their query heads from its columns of ``wq`` / ``wk`` /
    ``wv`` (and ``bq`` / ``bv``) through :func:`attention.attend_chunked`
    on its device, and its rows of ``wo`` give a partial output; the
    partials are added in shard order on x's device, then ``bo`` once.
    Returns (out, None) then."""
    if isinstance(p["wq"], Blocks):
        if kv_prefix is not None or kv_override is not None:
            raise ValueError("a tensor-parallel attention takes no "
                             "kv_prefix or kv_override")
        m = len(p["wq"].parts)
        sub = dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                                  n_kv_heads=cfg.n_kv_heads // m)
        out = None
        for pj in _shard_leaves(p, "bo"):
            dev = pj["wq"].device
            y = _attn_apply(sub, pj, x.to(dev), positions.to(dev),
                            causal=causal, window=window,
                            q_offset=q_offset)[0].to(x.device)
            out = y if out is None else out + y
        return (out if p.get("bo") is None else out + p["bo"]), None
    B, S, _ = x.shape
    rope_on = cfg.pos_embedding == "rope"
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.d_head)
    if kv_override is None:
        k = _proj(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
        v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, cfg.n_kv_heads,
                                                   cfg.d_head)
        if rope_on:
            q = rope.apply_rope(q, positions, cfg.rope_theta)
            k = rope.apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        if rope_on and causal:
            q = rope.apply_rope(q, positions, cfg.rope_theta)
    cut = 0                 # leading key rows attention does not read
    if kv_prefix is not None:
        pk, pv = kv_prefix
        if pk.shape[1] != q_offset:
            raise ValueError(f"kv_prefix holds {pk.shape[1]} positions, "
                             f"q_offset is {q_offset}")
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)
        if 0 < window < q_offset and causal and kv_override is None:
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
                      cascade: dict | None = None,
                      scales: tuple[torch.Tensor, torch.Tensor] | None
                      = None, shards: list | None = None):
    """One-token decode attention for a batch of slot lanes, reading K/V in
    place from one layer's slice of the paged block arena.

    x1: (S, 1, d) normed activations; k_blocks, v_blocks: (num_blocks, 1,
    bs, Hkv, Dh), one layer of ``engine.init_paged_arena``; tables: (S, nb)
    int32; pos: (S,) int32 lengths (the new token's row index).  Returns
    (out (S, 1, d), k1, v1), k1/v1 the (S, Hkv, Dh) post-RoPE rows the
    caller writes into the arena after the layer loop; attention reads them
    at ``pos`` in place of the arena's row (``backend`` "plain", "cuda" or
    "cascade" with the group metadata ``cascade``, see
    :func:`repro_torch.nn.attention.attend_decode_paged`).

    ``scales``: (k_scale_blocks, v_scale_blocks), each (num_blocks, 1, bs,
    Hkv, 1) float32, one layer of the int8 ``kv_quant`` scale arenas.  The
    new row is quantized post-RoPE, and the plain read dequantizes the
    gathered view with the dequantized-quantized row spliced in, what the
    dense int8 tick reads after its write.  Returns (out, k1q, v1q, k1_scale,
    v1_scale) then; only the plain backend covers the layout, as in the
    reference (``ValueError`` for the others).

    ``shards``: the layer's arena shards over a slice's ``"model"`` axis
    (``attention.KVShard``, each with its own scales under the int8 layout)
    in place of ``k_blocks`` / ``v_blocks`` / ``scales``: the attention
    runs once per shard (:func:`repro_torch.nn.attention.attend_decode_shards`)
    and the shards' outputs are joined in head order on ``x1``'s device, so
    the output projection's reduction is the unsharded one."""
    B = x1.shape[0]
    q = _proj(x1, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k1 = _proj(x1, p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v1 = _proj(x1, p["wv"], p.get("bv")).reshape(B, 1, cfg.n_kv_heads,
                                                 cfg.d_head)
    if cfg.pos_embedding == "rope":
        posb = pos[:, None]
        q = rope.apply_rope(q, posb, cfg.rope_theta)
        k1 = rope.apply_rope(k1, posb, cfg.rope_theta)
    k1, v1 = k1[:, 0].contiguous(), v1[:, 0].contiguous()
    quant = scales is not None or (shards is not None
                                   and shards[0].scales is not None)
    if not quant:
        rows = (k1, v1)
        new_kv = rows
    else:
        (k1q, k1s), (v1q, v1s) = kvquant.quantize(k1), kvquant.quantize(v1)
        rows = (k1q, v1q, k1s, v1s)
        new_kv = (kvquant.dequantize(k1q, k1s, cfg.dtype),
                  kvquant.dequantize(v1q, v1s, cfg.dtype))
    if shards is not None:
        o = attention.attend_decode_shards(q, shards, tables, pos + 1,
                                           window=window, new_kv=new_kv,
                                           backend=backend, cascade=cascade,
                                           out_dtype=cfg.dtype)
    else:
        o = attention.attend_decode_paged(
            q, k_blocks[:, 0], v_blocks[:, 0], tables, pos + 1,
            window=window, new_kv=new_kv, backend=backend, cascade=cascade,
            scales=None if scales is None else (scales[0][:, 0],
                                                scales[1][:, 0]),
            out_dtype=cfg.dtype)
    out = _proj(o.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"],
                p.get("bo"))
    return (out, *rows)


def attn_decode(cfg: LMConfig, p: dict, x1: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, *, window: int = 0,
                active: torch.Tensor | None = None,
                scales: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """One-token decode attention for a batch of lanes against one layer
    of the dense cache, each lane at its own position.

    x1: (B, 1, d) normed activations; cache_k, cache_v: (B, Smax, Hkv, Dh),
    **updated in place**; pos: (B,) int32 lengths (the new token's row).
    Each lane's K/V row (post-RoPE under RoPE) lands at ``pos`` (clamped to Smax - 1,
    where the reference's ``dynamic_update_slice`` clamps it) and attention
    reads ``pos + 1`` positions.  With ``active`` (B,) bool, an inactive
    lane's row is put back as it was after the read: the cache is then
    bitwise the reference's masked tick, which selects every inactive
    lane's old cache.  ``scales`` (k_scale, v_scale), each (B, Smax, Hkv,
    1) float32 and updated in place too, is the int8 ``kv_quant`` layout:
    the row is quantized post-RoPE before it lands, and attention reads the
    whole cache dequantized to the model's dtype, as the reference's tick
    does.  Returns (B, 1, d)."""
    B = x1.shape[0]
    q = _proj(x1, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k1 = _proj(x1, p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v1 = _proj(x1, p["wv"], p.get("bv")).reshape(B, 1, cfg.n_kv_heads,
                                                 cfg.d_head)
    if cfg.pos_embedding == "rope":
        posb = pos[:, None]
        q = rope.apply_rope(q, posb, cfg.rope_theta)
        k1 = rope.apply_rope(k1, posb, cfg.rope_theta)
    caches, rows = (cache_k, cache_v), (k1[:, 0], v1[:, 0])
    if scales is not None:
        (k1q, k1s), (v1q, v1s) = kvquant.quantize(k1), kvquant.quantize(v1)
        caches += tuple(scales)
        rows = (k1q[:, 0], v1q[:, 0], k1s[:, 0], v1s[:, 0])
    lanes = torch.arange(B, device=x1.device)
    at = pos.clamp(max=cache_k.shape[1] - 1).long()
    kept = None if active is None else [c[lanes, at].clone() for c in caches]
    for c, r in zip(caches, rows):
        c[lanes, at] = r.to(c.dtype)
    if scales is None:
        o = attention.attend_decode(q, cache_k, cache_v, pos + 1,
                                    window=window)
    else:
        o = attention.attend_decode(
            q, kvquant.dequantize(cache_k, scales[0], cfg.dtype),
            kvquant.dequantize(cache_v, scales[1], cfg.dtype), pos + 1,
            window=window)
    if kept is not None:
        keep = active[:, None, None]
        for c, old in zip(caches, kept):
            c[lanes, at] = torch.where(keep, c[lanes, at], old)
    return _proj(o.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"],
                 p.get("bo"))


def decoder_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  q_offset: int = 0, causal: bool = True,
                  kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None,
                  moe_layer: bool = False, moe_dropless: bool = False):
    """Pre-norm transformer block.  Returns (x, (k, v), aux): with
    ``kv_prefix`` (a chunk of the prefill fold, see :func:`_attn_apply`)
    k, v span prefix and chunk; aux is the MoE FFN's load-balance loss
    (None for a dense FFN), which the training forward adds to the loss
    and serving drops.  ``moe_layer`` runs the MoE FFN (``p["moe"]``) in
    groups of ``cfg.moe_group_size`` tokens; ``moe_dropless`` routes the
    whole (B, S) input as one group that drops nothing, so a token's output
    does not depend on the other tokens' routing (serving prefill,
    ``cfg.moe_dropless_prefill``)."""
    h, kv = _attn_apply(cfg, p["attn"], _norm_apply(cfg, p["ln1"], x),
                        positions, causal=causal, window=window,
                        q_offset=q_offset, kv_prefix=kv_prefix)
    x = x + h
    z = _norm_apply(cfg, p["ln2"], x)
    if not moe_layer:
        return x + _mlp_apply(cfg, p["mlp"], z), kv, None
    m = cfg.moe
    if moe_dropless:
        m = dataclasses.replace(m, group_size=z.shape[0] * z.shape[1],
                                dropless=True)
    y, aux = moe_lib.moe_ffn(z, p["moe"], m)
    return x + y, kv, aux


def cross_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor,
                enc_kv: tuple[torch.Tensor, torch.Tensor], *,
                q_offset: int = 0,
                kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None):
    """The cross block (the encdec decoder's, the vlm family's cross
    layer): causal self-attention (resumed from
    ``kv_prefix`` at ``q_offset`` in a fold chunk, see
    :func:`_attn_apply`), then cross-attention over the encoder's or the
    vision tokens' K/V ``enc_kv`` ((B, cross_len, Hkv, Dh) each, not
    causal, at offset 0, as the reference passes it; the queries take no
    RoPE) scaled by tanh(``gate_attn``) in float32, then the MLP.  Returns
    (x, (k, v)), the self-attention's rows."""
    h, kv = _attn_apply(cfg, p["attn"], _norm_apply(cfg, p["ln1"], x),
                        positions, causal=True, q_offset=q_offset,
                        kv_prefix=kv_prefix)
    x = x + h
    hx, _ = _attn_apply(cfg, p["xattn"], _norm_apply(cfg, p["ln_x"], x),
                        positions, causal=False, kv_override=enc_kv)
    x = x + _gate(p, x) * hx
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x)), kv


def _gate(p: dict, x: torch.Tensor) -> torch.Tensor:
    """tanh(``gate_attn``) in float32, cast to x's dtype."""
    return torch.tanh(p["gate_attn"].float()).to(x.dtype)


def cross_decode(cfg: LMConfig, p: dict, x: torch.Tensor,
                 xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """A decode tick's gated cross-attention for a (B, 1, d) activation
    against each lane's cross K/V ``xk``, ``xv`` (B, cross_len, Hkv, Dh):
    ``ln_x``, the query (biased where the block has ``bq``), the plain
    single-token attention over every frame or vision token
    (:func:`repro_torch.nn.attention.attend_decode`, as the reference's
    tick attends in XLA), the output projection (biased where the block
    has ``bo``) and the gate.  Returns what the tick adds to x, (B, 1,
    d)."""
    B, xa = x.shape[0], p["xattn"]
    q = _proj(_norm_apply(cfg, p["ln_x"], x), xa["wq"], xa.get("bq")
              ).reshape(B, 1, cfg.n_heads, cfg.d_head)
    o = attention.attend_decode(q, xk, xv, xk.shape[1])
    return _gate(p, x) * _proj(o.reshape(B, 1, -1), xa["wo"], xa.get("bo"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv: x (B, S, di), w (K, di), prev (B, K-1, di)
    the taps before x[:, 0].  Returns (out (B, S, di), the last K-1 inputs
    (B, K-1, di), the taps after x[:, -1]); the terms are summed in the
    reference's order."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([prev, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, -(K - 1):].contiguous()


def _ssm_inputs(cfg: LMConfig, p: dict, z: torch.Tensor, conv: torch.Tensor):
    """The SSM branch up to the scan: ``in_proj`` split into the stream
    and its gate, the causal conv over the stream and SiLU, then dt
    (softplus over ``dt_proj`` + ``dt_bias``, float32), B and C from
    ``x_proj``.  Returns (xm, gate, dt, Bm, Cm, the new conv taps)."""
    xm, gate = _proj(z, p["in_proj"]).chunk(2, dim=-1)
    xm, conv = _causal_conv(xm, p["conv_w"], conv)
    xm = torch.nn.functional.silu(xm.float()).to(z.dtype)
    dtr, N = p["dt_proj"].shape[0], cfg.ssm_state
    dbc = _proj(xm, p["x_proj"])
    dt = _proj(dbc[..., :dtr], p["dt_proj"]).float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus
    return xm, gate, dt, dbc[..., dtr:dtr + N], dbc[..., dtr + N:], conv


def _ssm_out(p: dict, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    y = y * torch.nn.functional.silu(gate.float()).to(y.dtype)
    return _proj(y, p["ssm_out"])


def hymba_mix(cfg: LMConfig, p: dict, x: torch.Tensor, att: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """The block's tail after its two branches: the attention and SSM
    outputs normed, mixed by ``beta`` in float32 and halved, added to the
    residual, then the SwiGLU MLP."""
    beta = p["beta"].float()
    mixed = (beta[0] * _norm_apply(cfg, p["norm_attn"], att).float()
             + beta[1] * _norm_apply(cfg, p["norm_ssm"], y).float()) * 0.5
    x = x + mixed.to(x.dtype)
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))


def hymba_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, state: dict, *, window: int,
                q_offset: int = 0,
                kv_prefix: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Parallel GQA attention and Mamba heads over a prompt or a fold
    chunk, mixed by ``beta``, then the MLP.  ``state``: {"conv": (B, K-1,
    di), "ssm": (B, di, N) float32}, the recurrent state at ``q_offset``
    (zeros for a prompt from its start), read and never written.  Returns
    (x, (k, v), the new state); the scan runs in chunks of
    ``min(cfg.ssm_chunk, S)`` steps, so a prompt of S tokens must be a
    multiple of that (``ssm.selective_scan`` raises otherwise, where the
    reference asserts)."""
    S = x.shape[1]
    z = _norm_apply(cfg, p["ln1"], x)
    att, kv = _attn_apply(cfg, p["attn"], z, positions, window=window,
                          q_offset=q_offset, kv_prefix=kv_prefix)
    xm, gate, dt, Bm, Cm, conv = _ssm_inputs(cfg, p, z, state["conv"])
    y, h = ssm.selective_scan(xm, dt.to(x.dtype), p["A_log"], Bm, Cm,
                              p["D_skip"], chunk=min(cfg.ssm_chunk, S),
                              state0=state["ssm"])
    x = hymba_mix(cfg, p, x, att, _ssm_out(p, y, gate))
    return x, kv, {"conv": conv, "ssm": h}


def ssm_decode(cfg: LMConfig, p: dict, z: torch.Tensor, conv: torch.Tensor,
               h: torch.Tensor):
    """A decode tick's SSM branch for a (B, 1, d) normed activation, from
    the lanes' conv taps (B, K-1, di) and state (B, di, N).  Returns (y
    (B, 1, d), the new taps, the new state); the inputs are not
    written."""
    xm, gate, dt, Bm, Cm, conv = _ssm_inputs(cfg, p, z, conv)
    y1, h = ssm.selective_step(xm[:, 0], dt[:, 0].to(z.dtype), p["A_log"],
                               Bm[:, 0], Cm[:, 0], p["D_skip"], h)
    return _ssm_out(p, y1[:, None], gate), conv, h


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(B, S, d) shifted right by one; ``last`` (B, d) fills position 0."""
    return torch.cat([last[:, None, :], x[:, :-1]], dim=1)


def rwkv_block(cfg: LMConfig, p: dict, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """The RWKV6 block over a prompt (S > 1) or one decode step (S == 1)
    from ``state`` {"wkv": (B, H, Dh, Dh) float32, "shift1", "shift2": (B,
    d)}, read and never written.  Returns (x, the new state).

    The time mix: ``ln1``, the token shift from ``shift1``, the r / k / v /
    g / w mixes by ``mu``, the decay w = exp(-exp(w0 + LoRA)) computed in
    float32 (no tanh, as in the reference) and rounded to x's dtype before
    either form reads it, :func:`repro_torch.nn.ssm.wkv6_step` at S == 1,
    else :func:`repro_torch.nn.ssm.wkv6_chunked` in chunks of
    ``min(cfg.rwkv_chunk, S)`` (so S must be a multiple of that: a
    ``ValueError`` where the reference asserts), RMSNorm ``ln_wkv``
    whatever ``norm_type`` is, the ``silu(g)`` gate in float32 cast back,
    ``wo``.  The channel mix: ``ln2``, the token shift from ``shift2``,
    relu(k)^2 and sigmoid(r) in float32, each cast back."""
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    f32 = torch.float32
    xa = _norm_apply(cfg, p["ln1"], x)
    xs = _token_shift(xa, state["shift1"])
    mu = p["mu"]

    def mix(i):
        return xa + (xs - xa) * mu[i]
    r, k, v = (_proj(mix(i), p[nm]).reshape(B, S, H, Dh)
               for i, nm in enumerate(("wr", "wk", "wv")))
    g = _proj(mix(3), p["wg"])
    ww = p["w0"].to(f32) + (_proj(mix(4), p["w_lora_a"])
                            @ p["w_lora_b"]).to(f32)
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, Dh).to(x.dtype)
    if S == 1:
        o1, wkv_state = ssm.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                      p["u"], state["wkv"])
        wkv = o1[:, None].to(x.dtype)
    else:
        wkv, wkv_state = ssm.wkv6_chunked(r, k, v, w, p["u"],
                                          chunk=min(cfg.rwkv_chunk, S),
                                          state0=state["wkv"])
    wkv = norms.rmsnorm(wkv.reshape(B, S, H * Dh), p["ln_wkv"]["scale"],
                        cfg.norm_eps)
    silu = torch.nn.functional.silu
    x = x + _proj(wkv * silu(g.to(f32)).to(x.dtype), p["wo"])
    xc = _norm_apply(cfg, p["ln2"], x)
    xcs = _token_shift(xc, state["shift2"])
    kr = xc + (xcs - xc) * mu[5]
    rr = xc + (xcs - xc) * mu[6]
    kk = torch.square(torch.relu(_proj(kr, p["cm_k"]).to(f32))).to(x.dtype)
    cm = torch.sigmoid(_proj(rr, p["cm_r"]).to(f32)).to(x.dtype) * \
        _proj(kk, p["cm_v"])
    return x + cm, {"wkv": wkv_state, "shift1": xa[:, -1],
                    "shift2": xc[:, -1]}


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
    """The embedding rows of ``tokens`` (a gather, whose backward on the
    card adds each row's gradients in a fixed order: a training step is
    reproducible bit for bit)."""
    return torch.nn.functional.embedding(tokens.long(), params["embed"])


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The reference's sinusoidal table at integer ``positions`` (any
    shape): (..., d) float32, the sines of the angles pos / 10000^(i / d),
    i = 0, 2, ..., d - 2, then their cosines, computed in float32 as the
    reference computes them.  The prompt, the fold, the encoder and every
    tick call this one function, so a position gets the same bits on every
    path."""
    i = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = positions.float()[..., None] / torch.pow(10000.0, i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def add_positions(cfg: LMConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """x plus the sinusoidal table at ``positions`` (cast to x's dtype)
    under ``pos_embedding="sinusoidal"``; x itself under RoPE, which
    encodes positions inside attention."""
    if cfg.pos_embedding != "sinusoidal":
        return x
    return x + sinusoidal(positions, cfg.d_model).to(x.dtype)


def embed_tick(cfg: LMConfig, params: dict, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """What a decode tick embeds: the rows of ``tokens`` (S, 1) at each
    lane's position ``pos`` (S,), without the SC frontend, as the
    reference's ticks index ``params["embed"]`` and skip it."""
    return add_positions(cfg, token_rows(params, tokens), pos[:, None])


def embed_tokens(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                 pos_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) integer -> (B, S, d): the embedding rows, the
    sinusoidal table from position ``pos_offset`` (the absolute position of
    tokens[:, 0]) under ``pos_embedding="sinusoidal"``, then the SC
    frontend's output under ``first_layer_mode="sc"`` (a residual
    insert)."""
    check_supported(cfg)
    x = token_rows(params, tokens)
    x = add_positions(cfg, x, torch.arange(
        pos_offset, pos_offset + tokens.shape[1], device=x.device))
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


# ==========================================================================
# Training: the whole-model forward and its loss.
# ==========================================================================

# the products whose outputs ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots_with_no_batch_dims``: a (B, S, d) @ (d, f) projection
# runs as one 2-d product; attention's batched products are recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
            CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def _maybe_remat(cfg: LMConfig, fn):
    """``fn`` under ``cfg.remat``: ``"none"`` keeps every activation for the
    backward; ``"full"`` keeps only ``fn``'s inputs and recomputes the rest
    in the backward (``torch.utils.checkpoint``, non-reentrant: the
    reference's ``jax.checkpoint``); ``"dots"`` also keeps the outputs of
    the 2-d matrix products."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r} (none, full, dots)")
    kw = {"context_fn": _dots_policy} if cfg.remat == "dots" else {}

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    return wrapped


def unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked parameter tree, each leaf split once
    with ``torch.unbind`` (whose backward stacks the layers' gradients
    once, where indexing a layer at a time would write a whole-stack
    gradient per layer)."""
    out = [{} for _ in range(n)]
    for key, value in tree.items():
        parts = unstack(value, n) if isinstance(value, dict) else \
            value.unbind() if isinstance(value, Blocks) else \
            torch.unbind(value)
        for i in range(n):
            out[i][key] = parts[i]
    return out


def chunked_xent(cfg: LMConfig, x: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, denom: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross-entropy with the vocabulary projection in chunks of
    ``cfg.loss_chunk`` positions, so the (S, V) logits never exist at full
    length: per chunk the float32 logits (products of the widened operands,
    float32 sums), the log-sum-exp minus the label's logit summed over the
    positions whose label is >= 0 (-1 is ignored), each chunk recomputed
    in the backward (the reference's ``jax.checkpoint``).  x (B, S, d),
    head (d, V), labels (B, S).  Returns (the mean over counted positions,
    their count as float32); with ``denom`` (a data-parallel shard of a
    microbatch: the microbatch's count, floored at 1) the sum over
    ``denom`` in place of the mean."""
    S = x.shape[1]
    ck = min(cfg.loss_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, ck):
        l, n = torch.utils.checkpoint.checkpoint(
            _chunk_loss, x[:, c0:c0 + ck], head, labels[:, c0:c0 + ck],
            use_reentrant=False, preserve_rng_state=False)
        tot = tot + l
        cnt = cnt + n
    if denom is not None:
        return tot / denom.to(tot.device), cnt
    return tot / torch.clamp(cnt, min=1.0), cnt


def _chunk_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor):
    logits = x.float() @ head.float()
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mask), torch.sum(mask, dtype=torch.float32)


def forward(cfg: LMConfig, params: dict, batch: dict, *,
            denom: torch.Tensor | None = None, aux_weight: float = 1.0
            ) -> tuple[torch.Tensor, dict]:
    """The training forward: next-token cross-entropy of every family,
    the reference's ``lm.forward``.

    batch: {"tokens": (B, S) integer, "labels": (B, S) integer (-1 =
    ignore)} and, for the encdec family, "enc_embed" (B, T_enc, d) frame
    embeddings, for the vlm family "vision_embed" (B, T_vis, d) patch
    embeddings.  Returns (loss + 0.01 * aux, {"loss", "aux", "tokens"}):
    the mean cross-entropy (:func:`chunked_xent`), the MoE layers' summed
    load-balance loss (float32 0 for the other families) and the count of
    labelled positions.

    The blocks are the serving blocks over the whole sequence from
    position 0: decoder and moe (its dense layer 0 first, then the MoE
    blocks, their windows counted from the first MoE block); rwkv from a
    zero state in every layer; hybrid with a fresh conv and SSM state in
    every layer (the reference's grouped static windows are the same
    function as the per-layer windows here); vlm with each cross layer's
    vision K/V projected from ``vision_embed``; encdec with the non-causal
    encoder over ``enc_embed`` plus sinusoidal positions, then
    ``enc_norm``, then every decoder layer's cross K/V.  Each stacked leaf
    is split once (:func:`unstack`) and each layer runs under
    ``cfg.remat`` (:func:`_maybe_remat`).

    A data-parallel shard of a microbatch (``train/step.py``) passes
    ``denom``, the microbatch's labelled positions floored at 1, and
    ``aux_weight``, its share of the microbatch's MoE routing groups: its
    loss is then its summed cross-entropy over ``denom`` plus ``0.01 *
    aux_weight * aux``, so the shards' losses (and gradients) add up to
    the microbatch's.  Leaves may be :class:`Blocks` (tensor
    parallelism)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    dev = x.device
    positions = torch.arange(S, device=dev).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    fam = cfg.family

    if fam in ("decoder", "moe"):
        def block(lp, x, window, moe_layer):
            x, _, a = decoder_block(cfg, lp, x, positions, window=window,
                                    moe_layer=moe_layer)
            return x, a
        run = _maybe_remat(cfg, block)
        if fam == "moe":
            x, _ = run(unstack(params["dense0"], 1)[0], x, 0, False)
        n = cfg.n_layers - (1 if fam == "moe" else 0)
        for i, lp in enumerate(unstack(params["blocks"], n)):
            x, a = run(lp, x, layer_window(cfg, i), fam == "moe")
            if a is not None:
                aux = aux + a

    elif fam == "rwkv":
        def block(lp, x):
            zero = {"wkv": torch.zeros((B, cfg.n_heads, cfg.d_head,
                                        cfg.d_head), dtype=torch.float32,
                                       device=dev),
                    "shift1": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                          device=dev),
                    "shift2": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                          device=dev)}
            return rwkv_block(cfg, lp, x, zero)[0]
        run = _maybe_remat(cfg, block)
        for lp in unstack(params["blocks"], cfg.n_layers):
            x = run(lp, x)

    elif fam == "hybrid":
        def block(lp, x, window):
            fresh = {"conv": torch.zeros((B, cfg.conv_k - 1, cfg.inner),
                                         dtype=x.dtype, device=dev),
                     "ssm": torch.zeros((B, cfg.inner, cfg.ssm_state),
                                        dtype=torch.float32, device=dev)}
            return hymba_block(cfg, lp, x, positions, fresh,
                               window=window)[0]
        run = _maybe_remat(cfg, block)
        for i, lp in enumerate(unstack(params["blocks"], cfg.n_layers)):
            x = run(lp, x, layer_window(cfg, i))

    elif fam == "vlm":
        vis = batch["vision_embed"].to(x.dtype)
        shape = (B, vis.shape[1], cfg.n_kv_heads, cfg.d_head)

        def self_block(lp, x):
            return decoder_block(cfg, lp, x, positions)[0]

        def cross(lp, x, vis):
            xa = lp["xattn"]
            kv = (_proj(vis, xa["wk"]).reshape(shape),
                  _proj(vis, xa["wv"]).reshape(shape))
            return cross_block(cfg, lp, x, positions, kv)[0]
        run_self, run_cross = _maybe_remat(cfg, self_block), \
            _maybe_remat(cfg, cross)
        k = cfg.cross_every
        selfs = unstack(params["blocks"], cfg.n_layers - cfg.n_cross)
        for g, lp in enumerate(unstack(params["cross_blocks"], cfg.n_cross)):
            for j in range(k - 1):
                x = run_self(selfs[g * (k - 1) + j], x)
            x = run_cross(lp, x, vis)

    elif fam == "encdec":
        enc = batch["enc_embed"].to(x.dtype)
        T = enc.shape[1]
        t = torch.arange(T, device=dev)
        enc = enc + sinusoidal(t, cfg.d_model).to(enc.dtype)
        enc_pos = t.expand(B, T)
        shape = (B, T, cfg.n_kv_heads, cfg.d_head)

        def enc_block(lp, h):
            return decoder_block(cfg, lp, h, enc_pos, causal=False)[0]

        def dec_block(lp, x, enc):
            xa = lp["xattn"]
            kv = (_proj(enc, xa["wk"]).reshape(shape),
                  _proj(enc, xa["wv"], xa.get("bv")).reshape(shape))
            return cross_block(cfg, lp, x, positions, kv)[0]
        run_enc, run_dec = _maybe_remat(cfg, enc_block), \
            _maybe_remat(cfg, dec_block)
        for lp in unstack(params["enc_blocks"], cfg.enc_layers):
            enc = run_enc(lp, enc)
        enc = _norm_apply(cfg, params["enc_norm"], enc)
        for lp in unstack(params["dec_blocks"], cfg.n_layers):
            x = run_dec(lp, x, enc)

    return _loss(cfg, params, x, batch["labels"], aux, denom, aux_weight)


def _loss(cfg: LMConfig, params: dict, x: torch.Tensor,
          labels: torch.Tensor, aux: torch.Tensor,
          denom: torch.Tensor | None, aux_weight: float):
    """The final norm, the chunked cross-entropy and the MoE term."""
    x = _norm_apply(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    loss, n_tok = chunked_xent(cfg, x, head, labels, denom)
    if aux_weight != 1.0:
        aux = aux * aux_weight
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "tokens": n_tok}


class _MetaGenerator:
    """What :func:`init` reads of a generator when it only shapes the
    parameters: a device."""
    device = torch.device("meta")


def count_params(cfg: LMConfig) -> int:
    """The parameters :func:`init` draws for ``cfg``, counted on the meta
    device (no memory)."""
    total = 0

    def walk(t):
        nonlocal total
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                total += v.numel()
    walk(init(cfg, _MetaGenerator()))
    return total


def active_params(cfg: LMConfig) -> int:
    """Parameters a token runs through: for the moe family the shared
    experts and ``top_k`` of the routed ones, as the reference counts
    them."""
    total = count_params(cfg)
    m = cfg.moe
    if m is None:
        return total
    routed = (cfg.n_layers - 1) * m.n_experts * 3 * cfg.d_model * m.d_expert
    return total - routed + routed * m.top_k // m.n_experts
