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

The vlm family's tick is the plain one: the reference runs its grouped
cache through the XLA tick only, refusing an explicit kernel or cascade
request and falling back without a word under auto-selection.  So an
explicit ``"cuda"`` or ``"cascade"`` for it raises, and ``None`` resolves
to ``"plain"`` on every device.
"""
from __future__ import annotations

import torch

BACKENDS = ("plain", "cuda", "cascade", "gather")
# the backends the reference refuses for the vlm family
NOT_FOR_VLM = ("cuda", "cascade")


def auto_backend(device: str | torch.device, family: str | None = None
                 ) -> str:
    """``"cuda"`` on a CUDA device, ``"plain"`` on the CPU, and for the
    vlm family ``"plain"`` everywhere."""
    if family == "vlm":
        return "plain"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def resolve_backend(backend: str | None, device: str | torch.device,
                    family: str | None = None) -> str:
    """``backend`` checked against the enum and, for the vlm family,
    against :data:`NOT_FOR_VLM`; ``None`` is :func:`auto_backend`."""
    if backend is None:
        return auto_backend(device, family)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if family == "vlm" and backend in NOT_FOR_VLM:
        raise ValueError(f"backend={backend!r} does not cover the vlm "
                         "family's tick (the reference refuses it too); "
                         "use backend=\"plain\"")
    return backend
