"""Mesh-axis conventions for the sharded serving gateway.

Convention (see ``launch.mesh``): the innermost mesh axis ``"model"``
carries tensor parallelism within a slice; every other axis (``"data"``)
is data parallel and indexes the slices.  A :class:`Mesh` is the port's
stand-in for a JAX device mesh: an array of ``torch.device`` with one axis
per name.  Devices may repeat, so several slices can share one card (a
one-H100 host) or the CPU (the tests).

The serving part of the reference's module is here: the meshes
(:func:`mesh_shape_dict`, :func:`slice_meshes`) and the spec helpers the
serving specs need (:class:`P`, :func:`dp_axes`, :func:`dp_size`,
:func:`axis_if_divisible`, :func:`batch_spec_axis`, pure functions of a
``mesh_shape`` dict).  ``zero_shard_rule`` / ``zero_shard_specs``,
``opt_state_specs``, ``named``, ``use_activation_mesh`` and ``hint`` wait
for the training meshes (ROADMAP §1, training meshes).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MODEL_AXIS = "model"


class P(tuple):
    """Stand-in for JAX's ``PartitionSpec``: per dimension, the mesh axis
    it shards over (a name, a tuple of names, or None: replicated).
    ``P()`` is the spec of a scalar; a spec compares equal to the tuple of
    its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def dp_axes(mesh_shape: dict[str, int]) -> tuple[str, ...]:
    """All non-"model" axes, outermost first (the data-parallel group)."""
    return tuple(a for a in mesh_shape if a != MODEL_AXIS)


def dp_size(mesh_shape: dict[str, int]) -> int:
    return math.prod(mesh_shape[a] for a in dp_axes(mesh_shape)) or 1


def axis_if_divisible(axis: str, size: int, mesh_shape: dict[str, int]):
    """``axis`` when ``size`` divides evenly over it, else None (replicate)."""
    return axis if size % mesh_shape.get(axis, 1) == 0 else None


def batch_spec_axis(mesh_shape: dict[str, int], batch: int):
    """DP axes to shard a batch dim over: the longest suffix-aligned group
    of DP axes whose product divides ``batch`` (a single axis collapses to
    its bare name), or None."""
    axes = dp_axes(mesh_shape)
    for i in range(len(axes)):
        cand = axes[i:]
        size = math.prod(mesh_shape[a] for a in cand)
        if size > 1 and batch % size == 0:
            return cand[0] if len(cand) == 1 else cand
    return None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per
    ``axis_names`` entry (the shape of a JAX ``Mesh``'s ``devices``)."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, object)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devs.shape} for axes "
                             f"{self.axis_names}")

    @property
    def device_list(self) -> list[torch.device]:
        """The devices in mesh order, flattened."""
        return list(self.devices.reshape(-1))


def mesh_shape_dict(mesh: Mesh) -> dict[str, int]:
    """{axis_name: size} for a mesh (insertion order = mesh order)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def slice_meshes(mesh: Mesh) -> list[Mesh]:
    """Factor a serving mesh into one ``("model",)`` sub-mesh per
    data-parallel coordinate: the ``"model"`` axis is kept (tensor
    parallelism within a slice), every other axis flattened into the slice
    index, so a (4, 2) ``("data", "model")`` mesh yields 4 two-device
    sub-meshes; a mesh with no ``"model"`` axis yields one single-device
    slice per device.  These are the units the sharded gateway
    (``serve/shard/``) schedules over, each slice owning its own block
    pool and arena on its sub-mesh's devices."""
    devs, names = mesh.devices, mesh.axis_names
    if MODEL_AXIS in names:
        devs = np.moveaxis(devs, names.index(MODEL_AXIS), -1)
        flat = devs.reshape(-1, devs.shape[-1])
    else:
        flat = devs.reshape(-1, 1)
    return [Mesh(flat[i], (MODEL_AXIS,)) for i in range(flat.shape[0])]


def slice_mesh(group) -> Mesh:
    """One slice's ``("model",)`` sub-mesh from such a sub-mesh
    (:func:`slice_meshes`, ``launch.mesh.make_disagg_meshes``) or a list
    of devices."""
    if isinstance(group, Mesh):
        if group.axis_names != (MODEL_AXIS,):
            raise ValueError(f"a slice's sub-mesh has the one axis "
                             f"{MODEL_AXIS!r}, not {group.axis_names}")
        return group
    if not isinstance(group, (list, tuple)):
        raise TypeError(f"a slice is a list of devices or a sub-mesh, not "
                        f"{group!r}")
    return Mesh(np.asarray([torch.device(d) for d in group], object),
                (MODEL_AXIS,))
