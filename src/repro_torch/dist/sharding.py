"""Mesh-axis conventions and sharding helpers shared by serving and
training (the reference's ``repro/dist/sharding.py``).

Convention (see ``launch.mesh``): the innermost mesh axis ``"model"``
carries tensor parallelism; every other axis (``"pod"``, ``"data"``) is
data parallel.  A :class:`Mesh` is the port's stand-in for a JAX device
mesh: an array of ``torch.device`` with one axis per name.  Devices may
repeat, so several coordinates can share one card (a one-H100 host) or
the CPU (the tests).

Specs are functions of the mesh, never baked into parameters, which is
what makes a restart on another mesh elastic.  The spec helpers are pure
functions of a ``mesh_shape`` dict and equal the reference's:
:class:`P`, :func:`dp_axes`, :func:`dp_size`, :func:`axis_if_divisible`,
:func:`batch_spec_axis`, ZeRO-1's :func:`zero_shard_rule` (an optimizer
leaf's largest free dim divisible by the data-parallel size sharded over
the data-parallel axes), :func:`zero_shard_specs` and
:func:`opt_state_specs`.  ``use_activation_mesh`` and ``hint`` keep the
reference's interface; the port partitions explicitly
(``train/step.py``), so ``hint`` returns ``x`` itself and
:func:`resolve_hint` gives the spec the reference would constrain to.

Placement (the port's own, where the reference has ``NamedSharding`` and
``jax.device_put``): a :class:`Sharded` leaf holds one local tensor per
mesh coordinate, on that coordinate's device, cut as its spec says
(:func:`shard`; :func:`gather` joins the pieces on one device).  The
spec's boxes are computed here (:func:`box`, :func:`cells`); the tensors
move in ``dist/collectives.py``.  A spec that names a mesh axis twice
(``zero_shard_rule`` does not look at the axes a spec already uses, and
JAX refuses such a spec) is cut by that axis at its first dim only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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


# ==========================================================================
# ZeRO-1: optimizer state sharded over the data-parallel group.
# ==========================================================================

def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map_specs(fn, specs, *rest):
    """``fn`` over a nested dict of specs, leaf for leaf with ``rest``
    (trees of the same structure)."""
    if _is_spec(specs):
        return fn(specs, *rest)
    return {k: _map_specs(fn, specs[k], *(r[k] for r in rest))
            for k in specs}


def zero_shard_rule(spec: P, shape: tuple[int, ...],
                    mesh_shape: dict[str, int]) -> P:
    """Shard the largest free (unsharded) dim divisible by the full DP size
    across the DP axes; leave the spec untouched when nothing fits."""
    n = dp_size(mesh_shape)
    axes = dp_axes(mesh_shape)
    if n <= 1:
        return spec
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    best = None
    for i, (dim, ax) in enumerate(zip(shape, padded)):
        if ax is None and dim > 0 and dim % n == 0:
            if best is None or dim > shape[best]:
                best = i
    if best is None:
        return spec
    out = list(padded)
    out[best] = axes[0] if len(axes) == 1 else axes
    return P(*out)


def zero_shard_specs(specs, params, mesh_shape: dict[str, int]):
    """:func:`zero_shard_rule` leaf for leaf (``params`` give the shapes:
    tensors, :class:`Sharded` leaves or anything with a ``shape``)."""
    return _map_specs(lambda sp, p: zero_shard_rule(sp, tuple(p.shape),
                                                    mesh_shape),
                      specs, params)


def opt_state_specs(param_specs, params, mesh_shape: dict[str, int], *,
                    master: bool = True) -> dict:
    """The spec tree of ``optim.init``'s state: the moments (and the
    float32 master copy) take the parameters' specs plus the ZeRO-1
    data-parallel sharding."""
    z = zero_shard_specs(param_specs, params, mesh_shape)
    out = {"step": P(), "m": z, "v": z}
    if master:
        out["master"] = z
    return out


# ==========================================================================
# Activation hints.
# ==========================================================================

_ACTIVATION_MESH: Mesh | None = None


@contextlib.contextmanager
def use_activation_mesh(mesh: Mesh):
    """Within the block, :func:`hint` resolves its axes on ``mesh``;
    outside it, nothing is resolved."""
    global _ACTIVATION_MESH
    prev, _ACTIVATION_MESH = _ACTIVATION_MESH, mesh
    try:
        yield mesh
    finally:
        _ACTIVATION_MESH = prev


def resolve_hint(shape: tuple[int, ...], axes: tuple,
                 mesh_shape: dict[str, int]) -> P:
    """The spec the reference's ``hint`` constrains an activation of
    ``shape`` to: ``"batch"`` becomes :func:`batch_spec_axis` of the dim,
    a named axis of size 1 or one that does not divide the dim becomes
    None."""
    out = []
    for dim, ax in zip(shape, axes):
        if ax == "batch":
            ax = batch_spec_axis(mesh_shape, dim)
        elif ax is not None:
            size = mesh_shape.get(ax, 1)
            if size <= 1 or dim % size:
                ax = None
        out.append(ax)
    return P(*out)


def hint(x, *axes):
    """The reference's activation hint.  The port partitions each step
    explicitly (``train/step.py`` splits the batch by
    :func:`batch_spec_axis`), so ``x`` is returned as it is, inside an
    activation mesh or not; :func:`resolve_hint` gives the spec."""
    return x


# ==========================================================================
# Placement: one local tensor per mesh coordinate.
# ==========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """Stand-in for JAX's ``NamedSharding``: a mesh and a spec."""
    mesh: Mesh
    spec: P


def named(mesh: Mesh, specs):
    """A spec tree -> a :class:`NamedSharding` tree on ``mesh``."""
    return _map_specs(lambda sp: NamedSharding(mesh, sp), specs)


def _dim_axes(sharding: NamedSharding, ndim: int) -> list[tuple[str, ...]]:
    """Per dim, the mesh axes that cut it, outermost first: the spec's
    entry less axes the mesh lacks and axes an earlier dim already uses."""
    names = sharding.mesh.axis_names
    used, out = set(), []
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    if len(spec) > ndim:
        raise ValueError(f"spec {sharding.spec} for a {ndim}-d leaf")
    for entry in spec:
        group = (entry,) if isinstance(entry, str) else tuple(entry or ())
        keep = tuple(a for a in group if a in names and a not in used)
        used.update(keep)
        out.append(keep)
    return out


def box(sharding: NamedSharding, shape: tuple[int, ...], coord: tuple
        ) -> tuple[tuple[int, int], ...]:
    """The [lo, hi) range per dim of the block mesh coordinate ``coord``
    holds of a leaf of ``shape``."""
    mesh = sharding.mesh
    size = dict(zip(mesh.axis_names, mesh.devices.shape))
    index = dict(zip(mesh.axis_names, coord))
    out = []
    for dim, axes in zip(shape, _dim_axes(sharding, len(shape))):
        n, i = 1, 0
        for a in axes:
            n, i = n * size[a], i * size[a] + index[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} "
                             f"({n} blocks) for spec {sharding.spec}")
        out.append((i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def coords(mesh: Mesh):
    """The mesh coordinates in mesh order (the last axis fastest)."""
    return itertools.product(*(range(n) for n in mesh.devices.shape))


def cells(sharding: NamedSharding, shape: tuple[int, ...]) -> list:
    """The distinct blocks of a leaf of ``shape``, each once, as (box, the
    first coordinate in mesh order that holds it), in that order."""
    seen = {}
    for c in coords(sharding.mesh):
        seen.setdefault(box(sharding, shape, c), c)
    return list(seen.items())


class Sharded:
    """A leaf stored as its spec says: ``pieces``, an object array of the
    mesh's shape, holds at each coordinate the tensor of the block
    :func:`box` gives it, on that coordinate's device.  Coordinates that
    replicate a block hold copies of their own."""

    def __init__(self, sharding: NamedSharding, shape: tuple[int, ...],
                 pieces: np.ndarray):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.pieces = pieces

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces.flat[0].dtype

    def box(self, coord: tuple) -> tuple[tuple[int, int], ...]:
        return box(self.sharding, self.shape, coord)

    def items(self):
        """(coordinate, box, tensor) for every coordinate, in mesh
        order."""
        for c in coords(self.mesh):
            yield c, self.box(c), self.pieces[c]

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={mesh_shape_dict(self.mesh)})")


def _map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_leaves(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def shard(tree, shardings):
    """Place each whole leaf of ``tree`` (a tensor on any device) as its
    :class:`NamedSharding` says: a :class:`Sharded` leaf whose pieces are
    copies of the leaf's blocks on their coordinates' devices."""
    from repro_torch.dist import collectives
    return _map_leaves(lambda t, sh: collectives.scatter(t, sh), tree,
                       shardings)


def gather(tree, device: str | torch.device):
    """Each :class:`Sharded` leaf joined whole on ``device`` (a leaf that
    is already a tensor is moved there)."""
    from repro_torch.dist import collectives
    dev = torch.device(device)

    def one(t):
        if isinstance(t, Sharded):
            return collectives.all_gather(t, None, dev)
        return t.to(dev)
    return _map_leaves(one, tree)


def shardings_of(tree):
    """The :class:`NamedSharding` of each :class:`Sharded` leaf."""
    return _map_leaves(lambda t: t.sharding, tree)
