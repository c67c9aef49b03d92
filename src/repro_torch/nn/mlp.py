"""The SwiGLU feed-forward block: silu in float32, cast back, then the
gate product in the activation dtype, as the reference does."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    h = x @ w_in
    return (F.silu(g.float()).to(h.dtype) * h) @ w_out
