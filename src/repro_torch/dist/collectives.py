"""The moves between a mesh's devices that training needs, in one module.

Every move is a device copy, and every sum adds float32 terms in a fixed
order, so a run is bitwise the last one whatever the devices are.  No
``torch.distributed`` is used: one H100 is one card, where every mesh
device is ``cuda:0`` and NCCL refuses two ranks on one GPU, and the tests
repeat ``"cpu"``.  A backend over NCCL for meshes of distinct cards
replaces this file.

A block is a box, a [lo, hi) range per dim of the whole leaf
(``dist.sharding.box``).  Where several coordinates replicate a block, the
first in mesh order is read (``dist.sharding.cells``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import (NamedSharding, Sharded, box, cells,
                                       coords)


def _overlap(dst_box, src_box):
    """(slices into dst, slices into src) of the two boxes' intersection,
    or None when they do not meet."""
    d, s = [], []
    for (dl, dh), (sl, sh) in zip(dst_box, src_box):
        lo, hi = max(dl, sl), min(dh, sh)
        if lo >= hi:
            return None
        d.append(slice(lo - dl, hi - dl))
        s.append(slice(lo - sl, hi - sl))
    return tuple(d), tuple(s)


def whole(shape) -> tuple[tuple[int, int], ...]:
    """The box of a whole leaf of ``shape``."""
    return tuple((0, n) for n in shape)


def _size(b) -> tuple[int, ...]:
    return tuple(hi - lo for lo, hi in b)


def scatter(t: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """A whole tensor placed as ``sharding`` says: each coordinate's block,
    copied to its device."""
    shape = tuple(t.shape)
    pieces = np.empty(sharding.mesh.devices.shape, object)
    for c in coords(sharding.mesh):
        sl = tuple(slice(lo, hi) for lo, hi in box(sharding, shape, c))
        pieces[c] = t[sl].to(sharding.mesh.devices[c], copy=True,
                              memory_format=torch.contiguous_format)
    return Sharded(sharding, shape, pieces)


def all_gather(x: Sharded, region, device: torch.device,
               dtype: torch.dtype | None = None, *,
               view: bool = False) -> torch.Tensor:
    """The box ``region`` of ``x`` (None: the whole leaf) joined on
    ``device`` (cast to ``dtype`` where given): each distinct block that
    meets the region copied from the first coordinate holding it.  With
    ``view``, a region that is one coordinate's whole block on ``device``
    returns that piece itself (to be read, not written)."""
    region = whole(x.shape) if region is None else tuple(region)
    if view and dtype in (None, x.dtype):
        for c in coords(x.mesh):
            t = x.pieces[c]
            if t.device == torch.device(device) and x.box(c) == region:
                return t
    out = torch.empty(_size(region), dtype=dtype or x.dtype, device=device)
    for b, c in cells(x.sharding, x.shape):
        ov = _overlap(region, b)
        if ov is not None:
            out[ov[0]] = x.pieces[c][ov[1]].to(device)
    return out


def relayout(x: Sharded, sharding: NamedSharding,
             dtype: torch.dtype | None = None) -> Sharded:
    """``x`` placed as ``sharding`` says (the all-to-all of a re-shard),
    cast to ``dtype`` where given."""
    pieces = np.empty(sharding.mesh.devices.shape, object)
    for c in coords(sharding.mesh):
        pieces[c] = all_gather(x, box(sharding, x.shape, c),
                               sharding.mesh.devices[c], dtype)
    return Sharded(sharding, x.shape, pieces)


def copy_into(dst: Sharded, src: Sharded) -> None:
    """Overwrite every piece of ``dst`` with ``src``'s values of its block
    (cast to ``dst``'s dtype), in place: each distinct block of ``src``
    copied from the first coordinate holding it."""
    for c, b, t in dst.items():
        for sb, sc in cells(src.sharding, src.shape):
            ov = _overlap(b, sb)
            if ov is not None:
                t[ov[0]].copy_(src.pieces[sc][ov[1]])


def zeros(sharding: NamedSharding, shape, dtype: torch.dtype) -> Sharded:
    """A :class:`Sharded` leaf of zeros."""
    pieces = np.empty(sharding.mesh.devices.shape, object)
    for c in coords(sharding.mesh):
        pieces[c] = torch.zeros(_size(box(sharding, shape, c)), dtype=dtype,
                                device=sharding.mesh.devices[c])
    return Sharded(sharding, tuple(shape), pieces)


def reduce_scatter(out: Sharded, parts: list) -> None:
    """Add ``parts``, a list of (tensor, its box of the whole leaf), into
    every piece of the float32 ``out`` where they meet it, widened to
    float32 and in list order (the reduce-scatter of a gradient: every
    replica of a block takes the same sums in the same order)."""
    for c, b, t in out.items():
        for g, gb in parts:
            ov = _overlap(b, gb)
            if ov is not None:
                # float32 += the term widened exactly, in one kernel
                t[ov[0]].add_(g[ov[1]].to(t.device))


def square_sum(x: Sharded) -> torch.Tensor:
    """Σ x² over the whole leaf in float32: each distinct block's sum, added
    in block order on the first coordinate's device."""
    dev = x.pieces.flat[0].device
    total = None
    for _, c in cells(x.sharding, x.shape):
        s = torch.sum(torch.square(x.pieces[c].to(torch.float32))).to(dev)
        total = s if total is None else total + s
    return total


def send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A point-to-point copy of ``t`` to ``device`` (differentiable: the
    gradient comes back the same way)."""
    return t.to(device)
