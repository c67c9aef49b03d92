"""GPipe pipeline parallelism over a ``"stage"`` mesh axis (the
reference's ``repro/dist/pipeline.py``).

Stage s holds its slice of the parameters (the leading axis of every
leaf) on the mesh's s-th device along ``axis``; microbatches stream
through the stages, each stage's output handed to the next stage's device
by a point-to-point copy (``dist.collectives.send``).  The schedule runs
``n_micro + n_stages - 1`` ticks: at tick t stage s works on microbatch
t - s, so stage 0 injects microbatch t at tick t and the last stage emits
microbatch t - (n_stages - 1); a stage with no microbatch at a tick (the
pipeline's fill and drain) is idle.  The outputs are returned on the
first stage's device, where the reference replicates them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import Mesh


def _stage_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis``, the other axes at coordinate 0."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} lack {axis!r}")
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def _stage_params(params, s: int, device: torch.device):
    if isinstance(params, dict):
        return {k: _stage_params(v, s, device) for k, v in params.items()}
    return params[s].to(device)


def gpipe_apply(stage_fn, params, xs: torch.Tensor, mesh: Mesh,
                axis: str = "stage") -> torch.Tensor:
    """Apply ``n_stages`` chained ``stage_fn``s to each microbatch.

    stage_fn : (stage_params, x) -> y with y.shape == x.shape
    params   : nested dict of tensors with a leading (n_stages, ...) axis
    xs       : (n_micro, B, ...) microbatch stream
    Returns the (n_micro, B, ...) outputs on the first stage's device."""
    devs = _stage_devices(mesh, axis)
    n_stages, n_micro = len(devs), xs.shape[0]
    stage_params = [_stage_params(params, s, devs[s])
                    for s in range(n_stages)]
    held: list = [None] * n_stages     # each stage's input this tick
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            held[0] = collectives.send(xs[t], devs[0])
        ys = [None if held[s] is None else stage_fn(stage_params[s], held[s])
              for s in range(n_stages)]
        m = t - (n_stages - 1)
        if m >= 0:
            outs[m] = collectives.send(ys[-1], devs[0])
        held = [None] + [None if y is None else
                         collectives.send(y, devs[s + 1])
                         for s, y in enumerate(ys[:-1])]
    return torch.stack(outs)
