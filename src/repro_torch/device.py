"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it is a CUDA device and no
    CUDA device is present — the port never falls back to the CPU.  A bare
    ``"cuda"`` gets the current device's index, so the result compares equal
    to the ``.device`` of a tensor allocated there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
