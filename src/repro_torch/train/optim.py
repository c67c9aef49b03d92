"""Optimizers as plain functions over nested dicts of tensors.

AdamW with optional mixed precision: parameters may be bf16 while master
weights and moments are float32 (``state_dtype``, ``master_dtype``).  The
arithmetic is the reference's (``repro.train.optim``) in its float32 order:
``update = (m / bc1) / (sqrt(v / bc2) + eps)``, weight decay added to the
update, ``base - lr * update``, the global-norm clip on the gradients
first.  ``torch.optim.AdamW`` divides by ``sqrt(v) / sqrt(bc2) + eps`` and
decays the parameter on its own, so it rounds differently and is not used.
Each step of that order is one ``torch._foreach_*`` call over a group of
leaves (one rounding each, as separate operations; a few launches on the
card rather than a dozen per leaf).

Leaves are visited in sorted key order at every level, as ``jax.tree``
orders a dict, so the clip's sum of squares adds them in the same order.

:func:`apply_` updates the parameters, the master copy and the moments in
place, a bounded group of leaf slices at a time, as the reference's jitted
step does when it donates its inputs; :func:`apply` runs it on copies and
keeps the old trees.  The train step updates in place: at stablelm-3b's
2.8 B parameters one float32 copy of the model is 11.2 GB, and a second
state or whole-model temporaries would not fit beside the first on an
80 GB card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import (Sharded, mesh_shape_dict, named,
                                       opt_state_specs)


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
    parameters' device.  Over a mesh (``params`` of
    ``dist.sharding.Sharded`` leaves) the state is sharded as
    ``dist.sharding.opt_state_specs`` says (the parameters' specs plus
    ZeRO-1 over the data-parallel axes; ``step`` replicated): the moments
    made in place, the master copy re-sharded from the parameters."""
    ps = leaves(params)
    if isinstance(ps[0], Sharded):
        return _init_sharded(params, ps, cfg)
    state = {"step": torch.zeros((), dtype=torch.int32, device=ps[0].device),
             "m": unflatten(params, [torch.zeros_like(p, dtype=cfg.state_dtype)
                                     for p in ps]),
             "v": unflatten(params, [torch.zeros_like(p, dtype=cfg.state_dtype)
                                     for p in ps])}
    if cfg.master_dtype is not None:
        state["master"] = unflatten(params,
                                    [p.to(cfg.master_dtype) for p in ps])
    return state


def _init_sharded(params, ps: list[Sharded], cfg: AdamWConfig) -> dict:
    mesh = ps[0].mesh
    specs = unflatten(params, [p.spec for p in ps])
    opt = opt_state_specs(specs, params, mesh_shape_dict(mesh),
                          master=cfg.master_dtype is not None)
    shardings = {k: named(mesh, v) for k, v in opt.items()}
    zero = [collectives.zeros(sh, p.shape, cfg.state_dtype)
            for sh, p in zip(leaves(shardings["m"]), ps)]
    state = {"step": collectives.zeros(shardings["step"], (), torch.int32),
             "m": unflatten(params, zero),
             "v": unflatten(params, [
                 collectives.zeros(z.sharding, z.shape, cfg.state_dtype)
                 for z in zero])}
    if cfg.master_dtype is not None:
        state["master"] = unflatten(params, [
            collectives.relayout(p, sh, cfg.master_dtype)
            for p, sh in zip(ps, leaves(shardings["master"]))])
    return state


def _global_norm(grads: list) -> torch.Tensor:
    total = 0
    for g in grads:
        total = total + (collectives.square_sum(g) if isinstance(g, Sharded)
                         else torch.sum(torch.square(g.to(torch.float32))))
    return torch.sqrt(total)


def apply(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_state); nothing is updated
    in place: :func:`apply_` on copies of ``params`` and ``state``."""
    def copy(tree):
        return unflatten(tree, [t.clone(memory_format=torch.contiguous_format)
                                for t in leaves(tree)])
    return apply_(copy(params), grads, {k: copy(t) for k, t in state.items()},
                  cfg)


# elements updated at once by :func:`apply_` (256 MB in float32)
APPLY_CHUNK = 1 << 26


def _groups(views: list[list[torch.Tensor]]):
    """Slices of the leaves' flat views (``views[i]`` holds leaf ``i``'s
    parameter, gradient, moments...) gathered into groups of at most
    :data:`APPLY_CHUNK` elements, in leaf order; each group is one list per
    kind of tensor."""
    group, size = [], 0
    for vs in views:
        for lo in range(0, vs[0].numel(), APPLY_CHUNK):
            part = [t[lo:lo + APPLY_CHUNK] for t in vs]
            if group and size + part[0].numel() > APPLY_CHUNK:
                yield [list(col) for col in zip(*group)]
                group, size = [], 0
            group.append(part)
            size += part[0].numel()
    if group:
        yield [list(col) for col in zip(*group)]


def apply_(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step in place: ``params``, ``state["m"]``, ``state["v"]``,
    ``state["master"]`` and ``state["step"]`` are updated and returned as
    (params, state), and must be contiguous; ``grads`` are read, not
    written.  Each step of the update is one ``torch._foreach_*`` call
    over a group of leaf slices of at most :data:`APPLY_CHUNK` elements in
    all, so its float32 temporaries are a few such groups, never the whole
    model (the clip's sum of squares reads each gradient leaf whole, in
    leaf order).  Float32 moments and master are updated where they lie;
    a tensor of another dtype gets a float32 copy, written back rounded.

    Over a mesh (:class:`dist.sharding.Sharded` leaves, the gradients in
    the optimizer state's layout) each ZeRO-1 shard of the moments and
    the master is updated where it lies, leaf by leaf and device by
    device through the same body, then the parameters' shards are
    rewritten from the updated blocks (the master's, cast)."""
    ps, gs = leaves(params), leaves(grads)
    kinds = [ps, gs, leaves(state["m"]), leaves(state["v"])]
    if "master" in state:
        kinds.append(leaves(state["master"]))
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (_global_norm(gs) + 1e-9),
                            max=1.0)
    steps = [state["step"]] if not isinstance(state["step"], Sharded) else \
        [t for _, _, t in state["step"].items()]
    for t in steps:
        t.add_(1)
    stepf = steps[0].to(torch.float32)
    bc1, bc2 = (1.0 - torch.pow(torch.full_like(stepf, b), stepf)
                for b in (cfg.b1, cfg.b2))
    if not isinstance(ps[0], Sharded):
        # the gradient is read (any layout); the others are written through
        _adamw([[t.reshape(-1) if j == 1 else t.view(-1)
                 for j, t in enumerate(leaf)] for leaf in zip(*kinds)],
               scale, bc1, bc2, cfg)
        return params, state
    for p, g, m, *rest in zip(*kinds):
        # the parameter in the state's layout: the master copy itself
        # (one view, so the body's write of the parameter is the master's
        # own update), else the parameter's values re-laid
        pz = None if "master" in state else \
            collectives.relayout(p, m.sharding)
        by_dev: dict = {}
        for c, _, t in m.items():
            own = [x.pieces[c].view(-1) for x in rest]
            by_dev.setdefault(t.device, []).append(
                [own[-1] if pz is None else pz.pieces[c].view(-1),
                 g.pieces[c].reshape(-1), t.view(-1)] + own)
        for dev, views in by_dev.items():
            _adamw(views, None if scale is None else scale.to(dev),
                   bc1.to(dev), bc2.to(dev), cfg)
        collectives.copy_into(p, rest[-1] if pz is None else pz)
    return params, state


def _adamw(views: list[list[torch.Tensor]], scale, bc1, bc2,
           cfg: AdamWConfig) -> None:
    """The AdamW update of flat views, one list per leaf (or leaf shard):
    its parameter, gradient, moments and master copy where there is one;
    in groups of :func:`_groups`, in place."""
    b1, b2 = cfg.b1, cfg.b2
    f32 = torch.float32
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    for pc, gc, mc, vc, *mst in _groups(views):
        if scale is not None:
            gc = [g * scale.to(g.dtype) for g in gc]
        g32 = [g.to(f32) for g in gc]
        # ``to`` returns a float32 tensor itself, so these update in place
        m32, v32 = [m.to(f32) for m in mc], [v.to(f32) for v in vc]
        base = [t.to(f32) for t in (mst[0] if mst else pc)]
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, mul(g32, 1 - b1))
        torch._foreach_mul_(v32, b2)
        torch._foreach_add_(v32, mul(mul(g32, g32), 1 - b2))
        update = div(div(m32, bc1),
                     add(torch._foreach_sqrt(div(v32, bc2)), cfg.eps))
        if cfg.weight_decay > 0:
            update = add(update, mul(base, cfg.weight_decay))
        torch._foreach_sub_(base, mul(update, cfg.lr))
        writes = [(mc, m32), (vc, v32), (pc, base)]
        if mst:
            writes.append((mst[0], base))
        pairs = [(d, s) for dst, src in writes for d, s in zip(dst, src)
                 if d is not s]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs],
                                 [s for _, s in pairs])


def sgd(params, grads, lr: float):
    """Plain SGD: ``p - lr * g``."""
    return unflatten(params, [p - lr * g.to(p.dtype) for p, g in
                              zip(leaves(params), leaves(grads))])
