"""Dense feed-forward blocks: SwiGLU (llama-family) and GELU (whisper).
The activation runs in float32 and is cast back, then the products run in
the activation dtype, as the reference does."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    h = x @ w_in
    return (F.silu(g.float()).to(h.dtype) * h) @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor | None,
             w_out: torch.Tensor, b_out: torch.Tensor | None
             ) -> torch.Tensor:
    """(x @ w_in + b_in), GELU, then @ w_out + b_out; a bias of None adds
    nothing.  The GELU is the tanh approximation, ``jax.nn.gelu``'s
    default."""
    h = x @ w_in
    if b_in is not None:
        h = h + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = h @ w_out
    return y if b_out is None else y + b_out
