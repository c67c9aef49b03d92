"""Count-domain TFF adder tree (the part of ``repro.core.arith`` the SC frame
path needs).

The paper's TFF adder (Fig. 2b) outputs ``(c_x + c_y + s0) >> 1`` ones for
input popcounts ``c_x``, ``c_y`` and initial state ``s0``, so a whole tree of
them reduces to integer arithmetic on the leaf popcounts.  ``s0_mode`` fixes
each node's initial state: ``"zero"`` rounds down, ``"one"`` rounds up,
``"alt"`` alternates by node index within each level.
"""
from __future__ import annotations

import torch


def _node_s0(mode: str, level: int, index: torch.Tensor) -> torch.Tensor:
    if mode == "zero":
        return torch.zeros_like(index)
    if mode == "one":
        return torch.ones_like(index)
    if mode == "alt":
        return (index + level) & 1
    raise ValueError(f"unknown s0_mode {mode}")


def tree_depth(k: int) -> int:
    """Levels of the TFF tree over ``k`` leaves: ``ceil(log2(max(k, 2)))``."""
    return max(1, (max(k, 2) - 1).bit_length())


def tff_tree_counts(counts: torch.Tensor, s0_mode: str = "alt"
                    ) -> torch.Tensor:
    """Reduce ``(..., M)`` leaf popcounts through a TFF adder tree -> ``(...,)``.

    M is padded to the next power of two (at least 2) with zero leaves, as a
    fixed hardware tree pads unused inputs.  Level ``l`` pairs nodes
    ``(2i, 2i+1)`` with initial state ``_node_s0(mode, l, i)``.
    """
    M = counts.shape[-1]
    depth = tree_depth(M)
    pad = (1 << depth) - M
    if pad:
        counts = torch.cat(
            [counts, counts.new_zeros(counts.shape[:-1] + (pad,))], dim=-1)
    c = counts
    for level in range(depth):
        left = c[..., 0::2]
        right = c[..., 1::2]
        idx = torch.arange(left.shape[-1], dtype=c.dtype, device=c.device)
        c = (left + right + _node_s0(s0_mode, level, idx)) >> 1
    return c[..., 0]
