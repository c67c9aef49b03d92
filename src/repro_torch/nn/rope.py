"""Rotary position embeddings: half-split rotation (not interleaved),
computed in float32 and cast back, as the reference does."""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = -torch.arange(0, d_head, 2, dtype=torch.float32,
                         device=device) / d_head
    # a Python-scalar base: a base tensor built on the card from a host value
    # is a host-to-device copy, which synchronizes the stream on every call
    return torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
