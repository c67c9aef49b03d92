"""Mesh-axis conventions for the sharded serving gateway.

Convention (see ``launch.mesh``): the innermost mesh axis ``"model"``
carries tensor parallelism within a slice; every other axis (``"data"``)
is data parallel and indexes the slices.  A :class:`Mesh` is the port's
stand-in for a JAX device mesh: an array of ``torch.device`` with one axis
per name.  Devices may repeat, so several slices can share one card (a
one-H100 host) or the CPU (the tests).

Only the serving part of the reference's module is here
(:func:`mesh_shape_dict`, :func:`slice_meshes`); ZeRO, the optimizer specs
and the activation ``hint`` wait for training (ROADMAP §1, training and
tooling).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MODEL_AXIS = "model"


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
