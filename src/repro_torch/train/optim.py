"""Optimizers as plain functions over nested dicts of tensors.

AdamW with optional mixed precision: parameters may be bf16 while master
weights and moments are float32 (``state_dtype``, ``master_dtype``).  The
arithmetic is the reference's (``repro.train.optim``) in its float32 order:
``update = (m / bc1) / (sqrt(v / bc2) + eps)``, weight decay added to the
update, ``base - lr * update``, the global-norm clip on the gradients
first.  ``torch.optim.AdamW`` divides by ``sqrt(v) / sqrt(bc2) + eps`` and
decays the parameter on its own, so it rounds differently and is not used.
Each step of that order is one ``torch._foreach_*`` call over all the
leaves (one rounding each, as separate operations; a few launches on the
card rather than a dozen per leaf).

Leaves are visited in sorted key order at every level, as ``jax.tree``
orders a dict, so the clip's sum of squares adds them in the same order.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0                 # global-norm clip; 0 disables
    state_dtype: torch.dtype = torch.float32   # moment dtype
    master_dtype: torch.dtype | None = None    # f32 master copy of bf16 params


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def unflatten(tree, flat: list[torch.Tensor]):
    """A nested dict shaped like ``tree`` holding ``flat`` in :func:`leaves`
    order."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def init(params, cfg: AdamWConfig) -> dict:
    """``{"step", "m", "v"}`` (and ``"master"`` with ``master_dtype``),
    each moment shaped like ``params``; ``step`` is an int32 tensor on the
    parameters' device."""
    ps = leaves(params)
    state = {"step": torch.zeros((), dtype=torch.int32, device=ps[0].device),
             "m": unflatten(params, [torch.zeros_like(p, dtype=cfg.state_dtype)
                                     for p in ps]),
             "v": unflatten(params, [torch.zeros_like(p, dtype=cfg.state_dtype)
                                     for p in ps])}
    if cfg.master_dtype is not None:
        state["master"] = unflatten(params,
                                    [p.to(cfg.master_dtype) for p in ps])
    return state


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    total = 0
    for g in grads:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def apply(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_state); nothing is updated
    in place."""
    ps, gs = leaves(params), leaves(grads)
    step = state["step"] + 1
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (_global_norm(gs) + 1e-9),
                            max=1.0)
        gs = [g * scale.to(g.dtype) for g in gs]
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = (1.0 - torch.pow(torch.full_like(stepf, b), stepf)
                for b in (b1, b2))
    f32 = torch.float32
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    g32 = [g.to(f32) for g in gs]
    bases = [t.to(f32) for t in
             (leaves(state["master"]) if "master" in state else ps)]
    m_new = add(mul([m.to(f32) for m in leaves(state["m"])], b1),
                mul(g32, 1 - b1))
    v_new = add(mul([v.to(f32) for v in leaves(state["v"])], b2),
                mul(mul(g32, g32), 1 - b2))
    update = div(div(m_new, bc1),
                 add(torch._foreach_sqrt(div(v_new, bc2)), cfg.eps))
    if cfg.weight_decay > 0:
        update = add(update, mul(bases, cfg.weight_decay))
    masters = torch._foreach_sub(bases, mul(update, cfg.lr))
    new_p = [t.to(p.dtype) for t, p in zip(masters, ps)]
    new_m = [t.to(cfg.state_dtype) for t in m_new]
    new_v = [t.to(cfg.state_dtype) for t in v_new]
    new_state = {"step": step, "m": unflatten(params, new_m),
                 "v": unflatten(params, new_v)}
    if "master" in state:
        new_state["master"] = unflatten(
            params, [t.to(cfg.master_dtype) for t in masters])
    return unflatten(params, new_p), new_state


def sgd(params, grads, lr: float):
    """Plain SGD: ``p - lr * g``."""
    return unflatten(params, [p - lr * g.to(p.dtype) for p, g in
                              zip(leaves(params), leaves(grads))])
