"""The training step, the reference's ``repro/train/step.py``: gradient
accumulation over microbatches, optional int8 gradient compression, then
AdamW, on one device or over a mesh.

``make_train_step(cfg, tcfg, mesh=None)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, {"loss", "grad_norm"})``.  The
gradients are ``torch.autograd.grad`` of
:func:`repro_torch.models.lm.forward` (the flash attention kernels'
backward on the card).  With ``microbatches`` = mb > 1 the batch's leading
axis is cut into mb slices, each slice's gradients are widened to float32
and added in order, then divided by mb, as the reference's scan does.  The
step updates ``params`` and ``opt_state`` in place (``optim.apply_``), as
the reference's jitted step donates them, and returns them.

Over a mesh (``mesh`` a ``dist.sharding.Mesh``) the parameters and the
optimizer state are ``dist.sharding.Sharded`` trees (the parameters as
``lm.param_specs`` says, the state ZeRO-1 sharded as
``dist.sharding.opt_state_specs`` says) and the step computes the
reference's one-device function, partitioned explicitly where the
reference lets GSPMD partition it:

- microbatch i is the global rows [i n, (i + 1) n); its rows are split
  over the data-parallel coordinates by ``batch_spec_axis`` (coordinate c
  of the k it names takes the c-th block of them), and a coordinate
  outside those k computes nothing (the batch is replicated over it);
- each data-parallel coordinate runs on its row of the mesh (its
  ``"model"`` group): attention and the dense MLPs tensor-parallel over
  the group as ``lm.tp_plan`` says, everything else on the group's first
  device, each leaf gathered there from its shards once a step;
- a coordinate's loss is its summed cross-entropy over the microbatch's
  labelled positions (counted from the labels before the forward), so
  the coordinates' losses add up to the microbatch's mean; the moe
  family's routing groups stay whole: where a coordinate would hold part
  of a group (or the groups do not divide over the coordinates), the
  first coordinate computes the whole microbatch, as GSPMD's replicated
  group axis routes it (the step function counts such microbatches in
  ``moe_unsplit_microbatches``);
- one ``torch.autograd.grad`` per coordinate; each leaf's gradient is
  summed over the coordinates in float32, in coordinate order, into the optimizer
  state's layout (the reduce-scatter), then cast once to the parameter's
  dtype, and accumulated over microbatches as above;
- ``compress_grads`` quantizes each reduced leaf whole (its chunks over
  the flattened whole leaf), never a shard; the clip's global norm sums
  every distinct block once, in a fixed order.

The moves between devices are ``dist/collectives.py``'s.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist import collectives
from repro_torch.dist import compress as compress_lib
from repro_torch.dist.sharding import (Mesh, batch_spec_axis,
                                       mesh_shape_dict, slice_meshes)
from repro_torch.models import lm
from repro_torch.train import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    adamw: optim.AdamWConfig = optim.AdamWConfig(
        lr=3e-4, weight_decay=0.1, grad_clip=1.0, master_dtype=torch.float32)
    compress_grads: bool = False     # int8 chunked compression before reduce
    compress_chunk: int = 2048


METRICS_KEYS = ("loss", "grad_norm")


def init_opt_state(params, tcfg: TrainConfig) -> dict:
    return optim.init(params, tcfg.adamw)


def value_and_grad(cfg: lm.LMConfig, params, batch: dict):
    """(loss, metrics, gradients): the forward's loss and metrics and the
    loss's gradient for every parameter leaf, a tree shaped like
    ``params`` in the parameters' dtypes."""
    ps = optim.leaves(params)
    live = [p.detach().requires_grad_() for p in ps]
    loss, metrics = lm.forward(cfg, optim.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        optim.unflatten(params, grads)


def make_train_step(cfg: lm.LMConfig, tcfg: TrainConfig,
                    mesh: Mesh | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` leaves are tensors (B, ...) with B a
    multiple of ``tcfg.microbatches``, on the parameters' device (one
    device) or on any device (a mesh: the step sends each coordinate its
    rows).  ``mesh``: None for one device, else the mesh the parameters
    and the optimizer state are sharded over (see the module's
    docstring); the step function then carries ``tp_layers``, the layers
    ``lm.tp_plan`` splits and gathers, and ``moe_unsplit_microbatches``,
    the moe family's microbatches so far whose routing groups did not
    divide over the data-parallel coordinates."""
    if mesh is not None:
        return _mesh_step(cfg, tcfg, mesh)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb == 1:
            loss, _, grads = value_and_grad(cfg, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % mb:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatches {mb}")
            n = B // mb
            acc = loss = None
            for i in range(mb):
                part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, _, g = value_and_grad(cfg, params, part)
                g = [t.to(torch.float32) for t in optim.leaves(g)]
                if acc is None:
                    acc = [torch.zeros_like(t) for t in g]
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                acc = [a + t for a, t in zip(acc, g)]
                loss = loss + l
            grads = optim.unflatten(params, [a / mb for a in acc])
            loss = loss / mb
        if tcfg.compress_grads:
            grads = optim.unflatten(params, [
                compress_lib.int8_roundtrip(g, tcfg.compress_chunk)
                for g in optim.leaves(grads)])
        params, opt_state = optim.apply_(params, grads, opt_state,
                                         tcfg.adamw)
        metrics = {"loss": loss,
                   "grad_norm": optim._global_norm(optim.leaves(grads))}
        return params, opt_state, metrics

    return train_step


def _rows_of(batch: dict, lo: int, hi: int, device) -> dict:
    return {k: v[lo:hi].to(device) for k, v in batch.items()}


def _groups_whole(cfg: lm.LMConfig, tokens: int, k: int) -> bool:
    """Whether each of k data-parallel shards of a microbatch of
    ``tokens`` tokens holds whole MoE routing groups."""
    gs = min(cfg.moe_group_size, tokens)
    return (tokens // k) % gs == 0


def _coordinate(params, plan, devs: list, memo: dict, index: dict):
    """One data-parallel coordinate's view of the sharded parameters: a
    tree like ``params`` whose leaves are gathered from their shards (a
    tensor whole on the group's first device, or :class:`lm.Blocks` of
    model shard j's block on the group's j-th device where ``plan`` splits
    the leaf), each an autograd leaf of its own; and the list of (leaf
    index, autograd leaf, its box of the whole leaf).  Gathers are made
    once a step and device (``memo``); coordinates on one device share
    their storage."""
    live = []

    def fetch(x, region, dev):
        key = (id(x), region, str(dev))
        if key not in memo:
            memo[key] = collectives.all_gather(x, region, dev, view=True)
        t = memo[key].detach().requires_grad_()
        live.append((index[id(x)], t, region or collectives.whole(x.shape)))
        return t

    def walk(tree, plan):
        if isinstance(tree, dict):
            return {k: walk(tree[k], plan[k]) for k in tree}
        if plan is None or len(devs) == 1:
            return fetch(tree, None, devs[0])
        m, n = len(devs), tree.shape[plan]
        parts = []
        for j, dev in enumerate(devs):
            region = list(collectives.whole(tree.shape))
            region[plan] = (j * n // m, (j + 1) * n // m)
            parts.append(fetch(tree, tuple(region), dev))
        return lm.Blocks(parts, plan)
    return walk(params, plan), live


def _mesh_step(cfg: lm.LMConfig, tcfg: TrainConfig, mesh: Mesh):
    ms = mesh_shape_dict(mesh)
    rows = [g.device_list for g in slice_meshes(mesh)]
    plan, counts = lm.tp_plan(cfg, ms)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        B = next(iter(batch.values())).shape[0]
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of microbatches "
                             f"{mb}")
        n = B // mb
        axis = batch_spec_axis(ms, n)
        k = 1 if axis is None else math.prod(
            ms[a] for a in ((axis,) if isinstance(axis, str) else axis))
        ps, ms_ = optim.leaves(params), optim.leaves(opt_state["m"])
        index = {id(p): i for i, p in enumerate(ps)}
        home = rows[0][0]
        S = batch["tokens"].shape[1]
        if cfg.family == "moe" and k > 1 and \
                not _groups_whole(cfg, n * S, k):
            k = 1
            train_step.moe_unsplit_microbatches += mb
        memo: dict = {}
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=home)
        for i in range(mb):
            red = [collectives.zeros(m.sharding, m.shape, torch.float32)
                   for m in ms_]
            labels = batch["labels"][i * n:(i + 1) * n]
            denom = torch.clamp(torch.sum(labels >= 0, dtype=torch.float32),
                                min=1.0).to(home)
            loss_i = None
            for c in range(k):
                tree, live = _coordinate(params, plan, rows[c], memo, index)
                out, _ = lm.forward(cfg, tree, _rows_of(
                    batch, i * n + c * n // k, i * n + (c + 1) * n // k,
                    rows[c][0]), denom=denom, aux_weight=1.0 / k)
                out = out.to(home)
                grads = torch.autograd.grad(out, [t for _, t, _ in live],
                                            allow_unused=True)
                parts: list = [[] for _ in ps]
                for (li, _, region), g in zip(live, grads):
                    if g is not None:
                        parts[li].append((g, region))
                del grads, tree, live
                for r, pl in zip(red, parts):
                    collectives.reduce_scatter(r, pl)
                del parts
                out = out.detach()
                loss_i = out if loss_i is None else loss_i + out
            # microbatch i's gradient: the float32 sum cast once to the
            # parameter's dtype
            g_i = []
            for j, p in enumerate(ps):
                g_i.append(red[j] if p.dtype == torch.float32 else
                           collectives.relayout(red[j], red[j].sharding,
                                                p.dtype))
                red[j] = None
            loss = loss_i if mb == 1 else loss + loss_i
            if mb == 1:
                acc = g_i
            else:
                if acc is None:
                    acc = [collectives.zeros(g.sharding, g.shape,
                                             torch.float32) for g in g_i]
                for a, g in zip(acc, g_i):
                    for c, _, t in a.items():
                        t.add_(g.pieces[c].to(torch.float32))
                del g_i
        if mb > 1:
            for a in acc:
                for c, _, t in a.items():
                    t.div_(mb)
            loss = loss / mb
        memo.clear()
        if tcfg.compress_grads:
            acc = [collectives.scatter(compress_lib.int8_roundtrip(
                collectives.all_gather(g, None, home), tcfg.compress_chunk),
                g.sharding) for g in acc]
        grads = optim.unflatten(params, acc)
        params, opt_state = optim.apply_(params, grads, opt_state,
                                         tcfg.adamw)
        metrics = {"loss": loss,
                   "grad_norm": optim._global_norm(optim.leaves(grads))}
        return params, opt_state, metrics

    train_step.tp_layers = counts
    train_step.moe_unsplit_microbatches = 0
    return train_step

