"""Mesh construction over ``torch.device`` lists: the production and
training meshes and the serving meshes.

Functions, not module-level constants: importing this module touches no
device.  A mesh's devices are laid round-robin over the devices of the
requested type (``"cuda"``: every visible card; ``"cpu"``: the one CPU)
in mesh order, the last axis fastest (slice after slice and, within a
slice of ``model`` devices, device after device), as the reference's
``jax.make_mesh`` lays them; so devices repeat when the mesh wants more
than there are: on one H100 every coordinate is ``cuda:0``, and on the
CPU ``"cpu"`` (the port's stand-in for the reference's forced host
devices).  An explicit index (``"cuda:1"``) puts everything there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Mesh


def _check_width(**widths: int) -> None:
    for name, m in widths.items():
        if m < 1:
            raise ValueError(f"{name}={m}: a slice needs a device")


def _devices(device: str | torch.device) -> list[torch.device]:
    """The devices slices are laid over: every visible card for a bare
    ``"cuda"``, the one named otherwise (raises without a card, as every
    entry point of the port does)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device = "cuda") -> Mesh:
    """An arbitrary mesh (elastic scaling, tests) with the axis-name
    contract of ``dist.sharding``: ``"model"`` innermost for tensor
    parallelism, every other axis data parallel."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    devs = _devices(device)
    grid = np.empty(shape, object)
    for i, c in enumerate(np.ndindex(*shape)):
        grid[c] = devs[i % len(devs)]
    return Mesh(grid, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> Mesh:
    """(16, 16) ``("data", "model")``, one pod of 256 chips, or (2, 16,
    16) ``("pod", "data", "model")``, two pods: ``"pod"`` cross-pod data
    parallelism (gradient sums only), ``"data"`` in-pod data parallelism
    with FSDP and ZeRO-1, ``"model"`` tensor parallelism (innermost)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_serving_mesh(n_slices: int | None = None, model: int = 1,
                      device: str | torch.device = "cuda") -> Mesh:
    """("data", "model") mesh of ``n_slices`` slices of ``model`` devices
    each for the sharded serving gateway (default: as many slices as the
    devices afford at ``model`` a slice, at least one).  Factor it with
    ``dist.sharding.slice_meshes`` into the per-slice ``("model",)``
    sub-meshes the gateway's router schedules over."""
    _check_width(model=model)
    devs = _devices(device)
    n = max(1, len(devs) // model) if n_slices is None else n_slices
    if n < 1:
        raise ValueError(f"a serving mesh needs a slice (n_slices={n})")
    grid = np.empty((n, model), object)
    for i in range(n):
        for j in range(model):
            grid[i, j] = devs[(i * model + j) % len(devs)]
    return Mesh(grid, ("data", "model"))


def make_disagg_meshes(n_prefill: int, n_decode: int, *,
                       prefill_model: int = 1, decode_model: int = 1,
                       device: str | torch.device = "cuda"
                       ) -> tuple[list[Mesh], list[Mesh]]:
    """Role-partitioned slice meshes for disaggregated prefill/decode:
    ``(prefill_meshes, decode_meshes)``, per-slice ``("model",)``
    sub-meshes of ``prefill_model`` and ``decode_model`` devices, prefill
    slices taking the leading devices.  Feed the concatenated list to
    ``shard.build_slices`` and describe the split with
    ``shard.RolePlan.split(n_prefill, n_decode)``."""
    if n_prefill < 1 or n_decode < 1:
        raise ValueError("disaggregation needs at least one slice per role")
    _check_width(prefill_model=prefill_model, decode_model=decode_model)
    devs = _devices(device)
    out, k = [], 0
    for n, model in ((n_prefill, prefill_model), (n_decode, decode_model)):
        role = []
        for _ in range(n):
            role.append(Mesh(np.asarray(
                [devs[(k + j) % len(devs)] for j in range(model)], object),
                ("model",)))
            k += model
        out.append(role)
    return out[0], out[1]
