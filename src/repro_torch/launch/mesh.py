"""Serving mesh construction over ``torch.device`` lists.

A function, not a module-level constant: importing this module touches no
device.  Slices are laid round-robin over the devices of the requested
type (``"cuda"``: every visible card; ``"cpu"``: the one CPU), so slices
share a device when there are more slices than devices: on one H100 every
slice lives on ``cuda:0``, and on the CPU every slice on ``"cpu"`` (the
port's stand-in for the reference's forced host devices).  An explicit
index (``"cuda:1"``) puts every slice there.  Tensor parallelism within a
slice (``model > 1``) is not ported (ROADMAP §1, sharded serving's model
axis); the production and training meshes wait for training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Mesh


def _check_model(model: int) -> None:
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism within a serving slice "
            "(engine.arena_specs) is not ported yet: ROADMAP.md §1, sharded "
            "serving's model axis")


def _devices(device: str | torch.device) -> list[torch.device]:
    """The devices slices are laid over: every visible card for a bare
    ``"cuda"``, the one named otherwise (raises without a card, as every
    entry point of the port does)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_serving_mesh(n_slices: int | None = None, model: int = 1,
                      device: str | torch.device = "cuda") -> Mesh:
    """("data", "model") mesh of ``n_slices`` single-device slices for the
    sharded serving gateway (default: one slice per device).  Factor it
    with ``dist.sharding.slice_meshes`` into the per-slice sub-meshes the
    gateway's router schedules over."""
    _check_model(model)
    devs = _devices(device)
    n = len(devs) if n_slices is None else n_slices
    if n < 1:
        raise ValueError(f"a serving mesh needs a slice (n_slices={n})")
    grid = np.empty((n, model), object)
    for i in range(n):
        grid[i, 0] = devs[i % len(devs)]
    return Mesh(grid, ("data", "model"))


def make_disagg_meshes(n_prefill: int, n_decode: int, *,
                       prefill_model: int = 1, decode_model: int = 1,
                       device: str | torch.device = "cuda"
                       ) -> tuple[list[Mesh], list[Mesh]]:
    """Role-partitioned slice meshes for disaggregated prefill/decode:
    ``(prefill_meshes, decode_meshes)``, per-slice ``("model",)``
    sub-meshes, prefill slices taking the leading devices.  Feed the
    concatenated list to ``shard.build_slices`` and describe the split with
    ``shard.RolePlan.split(n_prefill, n_decode)``."""
    if n_prefill < 1 or n_decode < 1:
        raise ValueError("disaggregation needs at least one slice per role")
    _check_model(prefill_model)
    _check_model(decode_model)
    devs = _devices(device)
    out, k = [], 0
    for n in (n_prefill, n_decode):
        role = []
        for _ in range(n):
            role.append(Mesh(np.asarray([devs[k % len(devs)]], object),
                             ("model",)))
            k += 1
        out.append(role)
    return out[0], out[1]
