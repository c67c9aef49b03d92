"""int8 KV-cache quantization: the ``kv_quant`` layout.

K/V rows are stored int8 with one float32 scale per (token, head), the
absmax of the row's ``D`` values floored at 1e-8 and divided by 127,
taken after RoPE; the read dequantizes the gathered view.  This halves
the cache's bytes (int8 plus 4 bytes a head, against 2 bytes a value in
bf16).  The arithmetic is the reference's, step for step, so equal inputs
give equal bits: the float32 quotient rounded half to even and clipped to
±127, and the float32 product cast to the target dtype.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 (..., D), float32 scale (..., 1))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The float32 product ``q * scale``, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
