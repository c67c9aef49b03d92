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
"""
from __future__ import annotations

import torch

BACKENDS = ("plain", "cuda", "cascade", "gather")


def auto_backend(device: str | torch.device) -> str:
    """``"cuda"`` on a CUDA device, ``"plain"`` on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def resolve_backend(backend: str | None, device: str | torch.device) -> str:
    """``backend`` checked against the enum; ``None`` is the device's
    :func:`auto_backend`."""
    if backend is None:
        return auto_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend
