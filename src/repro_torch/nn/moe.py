"""Fine-grained mixture-of-experts (DeepSeekMoE-style: shared experts and
many small routed experts, top-k with renormalized gates) in PyTorch.

Routing is GShard's, as the reference computes it: tokens split into
groups of ``group_size``; a group's (token, k) pairs take the next slot of
their expert's buffer of capacity C in token-major, then k, order, and a
pair whose slot is C or beyond is dropped.  Where the reference builds
(G, T, E, C) one-hot dispatch and combine tensors, the port gives each pair
its slot from a running count and moves rows by index: one scatter into an
(E, G*C, d) buffer (the group axis folded into each expert's rows), one
batched product per projection over the experts, one gather back.  Shapes
are fixed by (G, T, E, C) and nothing is read back to the host, so a
captured decode tick runs it.

The two combines are the reference's two dispatches: both sum a token's k
contributions over its experts in ascending order in float32 and round
the sum to the activation dtype once; ``"einsum"`` first rounds each gate
weight to the activation dtype (its combine tensor is built in
``x.dtype``), ``"sort"`` keeps it in float32 (its scatter-add widens the
``x.dtype`` buffer to float32 and narrows the sum).

An auxiliary load-balance loss (Switch) is returned for training; serving
drops it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import mlp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 2048
    aux_loss_weight: float = 0.01
    impl: str = "einsum"   # "einsum" | "sort"
    # dropless: capacity = the whole group, so routing never drops a token
    # (serving prefill: a token's output must not depend on which other
    # prompts share its dispatch group, or a prompt could not resume from
    # a cached prefix)
    dropless: bool = False


def capacity(cfg: MoEConfig, group_tokens: int) -> int:
    if cfg.dropless:
        return -(-group_tokens // 4) * 4    # every token always fits
    c = int(group_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, -(-c // 4) * 4)   # round up to 4 for layout


def _counts(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot of ``idx`` (..., m) over ``n`` classes, (..., m, n), by a
    scatter (no check that reads the indices back to the host)."""
    out = torch.zeros(idx.shape + (n,), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def router(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """x (G, T, d) -> (weights (G, T, k) float32, experts (G, T, k) int64,
    aux loss).  Float32 logits and softmax, the top k with ties to the
    lower expert (a stable descending sort, as ``lax.top_k``), renormalized
    by their sum floored at 1e-9."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style): E * mean(density * mean_prob)
    density = _counts(top_e, cfg.n_experts, torch.float32).mean(dim=(1, 2))
    aux = cfg.n_experts * torch.mean(
        torch.sum(density * probs.mean(dim=1), dim=-1))
    return top_w, top_e, aux


def slots(top_e: torch.Tensor, n_experts: int, C: int):
    """Each (token, k) pair's slot in its expert's buffer, (G, T, k): its
    running count among the group's pairs routed to that expert, in
    token-major then k order; and whether it fits (slot < C)."""
    G, T, k = top_e.shape
    flat = top_e.reshape(G, T * k)
    seen = _counts(flat, n_experts, torch.int32).cumsum(1)
    pos = seen.gather(2, flat[..., None])[..., 0].long() - 1
    return pos.reshape(G, T, k), (pos < C).reshape(G, T, k)


def _expert_ffn(xin: torch.Tensor, params: dict) -> torch.Tensor:
    """xin (E, R, d) -> SwiGLU per expert with weights (E, d, f) / (E, f, d):
    silu in float32, cast back, the product, the down projection."""
    g = torch.bmm(xin, params["w_gate"])
    h = torch.bmm(xin, params["w_in"])
    a = F.silu(g.float()).to(h.dtype) * h
    return torch.bmm(a, params["w_out"])


def _routed(x: torch.Tensor, top_w: torch.Tensor, top_e: torch.Tensor,
            cfg: MoEConfig, params: dict) -> torch.Tensor:
    """The routed experts' output for x (G, T, d)."""
    if cfg.impl not in ("einsum", "sort"):
        raise ValueError(f"unknown MoE dispatch {cfg.impl!r}")
    G, T, d = x.shape
    E, k = cfg.n_experts, top_e.shape[-1]
    C = capacity(cfg, T)
    pos, kept = slots(top_e, E, C)
    # buffer row of each pair: expert e's rows are (g, slot), g-major; a
    # dropped pair lands in one overflow row past the experts'
    group = torch.arange(G, device=x.device)[:, None, None]
    row = torch.where(kept, top_e * (G * C) + group * C + pos, E * G * C)
    buf = x.new_zeros(E * G * C + 1, d)
    buf.index_copy_(0, row.reshape(-1),
                    x[:, :, None].expand(G, T, k, d).reshape(-1, d))
    h = _expert_ffn(buf[:-1].view(E, G * C, d), params).reshape(-1, d)
    # a token's contributions over its experts in ascending order
    order = top_e.sort(dim=-1).indices
    row, kept, w = (t.gather(-1, order) for t in (row, kept, top_w))
    hg = h[row.clamp(max=E * G * C - 1)]                 # (G, T, k, d)
    if cfg.impl == "einsum":
        w = w.to(x.dtype).float()
    acc = None
    for i in range(k):
        c = torch.where(kept[..., i, None],
                        w[..., i, None] * hg[..., i, :].float(), 0.0)
        acc = c if acc is None else acc + c
    return acc.to(x.dtype)


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """x (B, S, d) -> (out (B, S, d), aux loss scalar).

    params: {w_router (d, E), w_gate/w_in (E, d, f), w_out (E, f, d),
    shared_gate/shared_in (d, n_shared*f), shared_out (n_shared*f, d)}.
    The B*S tokens route in groups of ``min(group_size, B*S)``, which must
    divide them."""
    B, S, d = x.shape
    tokens = B * S
    gs = min(cfg.group_size, tokens)
    if tokens % gs:
        raise ValueError(f"group_size {gs} must divide tokens {tokens}")
    xg = x.reshape(tokens // gs, gs, d)
    top_w, top_e, aux = router(xg, params["w_router"], cfg)
    out = _routed(xg, top_w, top_e, cfg, params).reshape(B, S, d)
    if cfg.n_shared > 0:
        out = out + mlp.swiglu(x, params["shared_gate"], params["shared_in"],
                               params["shared_out"])
    return out, aux
