"""Normalization layers, with the reference's numerics: the reductions
accumulate in float32, and the (..., 1) inverse is cast to the activation
dtype before it multiplies, so no full-size float32 intermediate exists."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias, eps: float = 1e-5
              ) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.square().mean(-1, keepdim=True) - mu.square()
    inv = torch.rsqrt(var + eps)
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    if isinstance(bias, (int, float)):
        return out * scale.to(x.dtype) + bias
    return out * scale.to(x.dtype) + bias.to(x.dtype)
