"""The attention-backend enum of the paged decode tick.

    backend="plain"    the in-place tick with the plain PyTorch attention
                       read (gather each chain + masked softmax) and an
                       indexed row write: the reference's ``"xla"``
    backend="cuda"     the in-place tick through the hand-written kernels:
                       ``paged_decode_attention`` in every layer and one
                       ``scatter_kv_rows`` launch per tick: the reference's
                       ``"pallas"``
    backend="cascade"  the in-place tick with shared-prefix cascade
                       attention: lanes sharing an indexed radix chain
                       attend it once per group (``cascade_prefix_attention``
                       and ``paged_decode_attention_with_state``, which
                       merges the two states in its epilogue, in every
                       layer: the kernels on a CUDA device, their plain
                       versions on the CPU); a
                       tick with no chain shared by two lanes runs the
                       device's flat tick (:func:`auto_backend`)
    backend="gather"   the gather-tick parity oracle: each lane's whole
                       table gathered into the dense layout, the dense
                       tick (``engine.decode_step``), and the block holding
                       each lane's new row scattered back; plain PyTorch on
                       every device, as the reference's is XLA

The vlm family's tick and the int8 ``kv_quant`` layout's are the plain
one: the reference runs its grouped cache and its int8 cache through the
XLA tick only, refusing an explicit kernel or cascade request and falling
back without a word under auto-selection.  So an explicit ``"cuda"`` or
``"cascade"`` for either raises, and ``None`` resolves to ``"plain"`` on
every device.
"""
from __future__ import annotations

import torch

BACKENDS = ("plain", "cuda", "cascade", "gather")
# the backends the reference refuses where the tick is plain only (the vlm
# family, the int8 layout)
KERNEL_TICKS = ("cuda", "cascade")


def plain_only(cfg) -> str | None:
    """What makes ``cfg``'s tick plain only, as the reference refuses its
    kernel and cascade ticks there (the vlm family's layout or the int8
    ``kv_quant`` layout), or None."""
    if cfg is None:
        return None
    if cfg.family == "vlm":
        return "the vlm family's tick"
    if cfg.kv_quant:
        return "the int8 kv_quant layout"
    return None


def auto_backend(device: str | torch.device, cfg=None) -> str:
    """``"cuda"`` on a CUDA device, ``"plain"`` on the CPU, and where
    :func:`plain_only` names a reason ``"plain"`` everywhere."""
    if plain_only(cfg):
        return "plain"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def resolve_backend(backend: str | None, device: str | torch.device,
                    cfg=None) -> str:
    """``backend`` checked against the enum and, where :func:`plain_only`
    names a reason, against :data:`KERNEL_TICKS`; ``None`` is
    :func:`auto_backend`."""
    if backend is None:
        return auto_backend(device, cfg)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    why = plain_only(cfg)
    if why and backend in KERNEL_TICKS:
        raise ValueError(f"backend={backend!r} does not cover {why} (the "
                         "reference refuses it too); use backend=\"plain\"")
    return backend
