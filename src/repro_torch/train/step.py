"""The training step, the reference's ``repro/train/step.py`` on one
device: gradient accumulation over microbatches, optional int8 gradient
compression, then AdamW.

``make_train_step(cfg, tcfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``.  The gradients are
``torch.autograd.grad`` of :func:`repro_torch.models.lm.forward` (the
flash attention kernels' backward on the card).  With ``microbatches`` =
mb > 1 the batch's leading axis is cut into mb slices, each slice's
gradients are widened to float32 and added in order, then divided by mb,
as the reference's scan does.  The step updates ``params`` and
``opt_state`` in place (``optim.apply_``), as the reference's jitted step
donates them, and returns them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import compress as compress_lib
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


def make_train_step(cfg: lm.LMConfig, tcfg: TrainConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` leaves are tensors (B, ...) on the
    parameters' device with B a multiple of ``tcfg.microbatches``."""

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
