"""Stochastic arithmetic primitives, in plain PyTorch.

Three levels of fidelity for the TFF adder, bit-exact to one another (the
tests hold each against ``repro.core.arith``):

  1. ``*_gate``   — cycle-exact gate-level simulation (a loop over the N
                    clock cycles on unpacked bool tensors), the paper's Fig. 2
                    schematic wire for wire;
  2. ``*_packed`` — word-parallel on packed int32 words;
  3. count domain — the TFF adder outputs ``(c_x + c_y + s0) >> 1`` ones for
                    input popcounts ``c_x``, ``c_y`` and initial state ``s0``,
                    so a whole tree reduces to integer arithmetic on the leaf
                    popcounts (what the ``sc_dot`` kernel computes).

Per clock cycle the new TFF adder (Fig. 2b) does: if ``x_t == y_t`` then
``z_t = x_t``; else ``z_t = state`` and ``state = !state``.  ``s0_mode``
fixes each tree node's initial state: ``"zero"`` rounds down, ``"one"``
rounds up, ``"alt"`` alternates by node index within each level.

Words are int32 bit patterns (``core/bitstream.py``); only left shifts are
used on them here, which wrap as on uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitstream
from repro_torch.device import resolve_device


# -- multiplier and the old adders -------------------------------------------

def mult(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unipolar stochastic multiplier (Fig. 1a): AND of packed streams."""
    return x & y


def or_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """OR-gate 'adder', accurate only near zero."""
    return x | y


def mux_add(x: torch.Tensor, y: torch.Tensor, select: torch.Tensor
            ) -> torch.Tensor:
    """Conventional scaled adder (Fig. 1b): a MUX driven by a p = 1/2 select
    stream.  ``~select`` sets the bits above N, where ``y``'s are zero, so
    the output keeps the streams' zero tail."""
    return (x & select) | (y & ~select)


def tff_select_stream(length: int, device: torch.device | str = "cuda"
                      ) -> torch.Tensor:
    """A TFF toggling every cycle, 0101...: a deterministic p = 1/2 select."""
    device = resolve_device(device)
    word = 0xAAAAAAAA - (1 << 32)       # bit t set iff t is odd, as int32
    return torch.full((bitstream.n_words(length),), word, dtype=torch.int32,
                      device=device) & bitstream.word_masks(length, device)


# -- the new TFF adder (Fig. 2b) ----------------------------------------------

def tff_add_gate(x_bits: torch.Tensor, y_bits: torch.Tensor,
                 s0: torch.Tensor | int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cycle-exact TFF adder on unpacked bool streams ``(..., N)``.

    Returns ``(z_bits, final_state)``.  ``s0`` selects the rounding (Fig.
    2c): 0 rounds down, 1 rounds up when ``c_x + c_y`` is odd.
    """
    x_bits = x_bits.to(torch.bool)
    y_bits = y_bits.to(torch.bool)
    state = torch.as_tensor(s0, device=x_bits.device).to(torch.bool) \
        .expand(x_bits.shape[:-1])
    zs = []
    for t in range(x_bits.shape[-1]):
        xt, yt = x_bits[..., t], y_bits[..., t]
        differ = xt ^ yt
        zs.append(torch.where(differ, state, xt))
        state = torch.where(differ, ~state, state)
    return torch.stack(zs, -1), state


def _prefix_parity_exclusive(d: torch.Tensor) -> torch.Tensor:
    """Bit ``t`` of the result: the parity of the set bits of ``d`` strictly
    before stream position ``t`` (``d``: int32 words ``(..., n_words)``)."""
    p = d
    for shift in (1, 2, 4, 8, 16):                 # inclusive, within a word
        p = p ^ (p << shift)
    excl = p ^ d
    word_par = bitstream.popcount_per_word(d) & 1
    carry = (torch.cumsum(word_par, -1, dtype=torch.int32) - word_par) & 1
    return excl ^ (0 - carry)                      # 1 -> every bit flipped


def tff_add_packed(x: torch.Tensor, y: torch.Tensor, length: int,
                   s0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed TFF adder, bit-exact to :func:`tff_add_gate`: at the j-th
    position where ``x != y`` the output is ``s0 ^ (j & 1)``, elsewhere
    ``x``.  Returns ``(z_packed, final_state)``, the state int32 in {0, 1}.
    """
    d = x ^ y
    par = _prefix_parity_exclusive(d)
    toggled = ~par if s0 else par
    masks = bitstream.word_masks(length, x.device)
    z = ((x & y) | (d & toggled)) & masks
    total_d = bitstream.popcount(d & masks)
    return z, (total_d & 1) ^ s0


def tff_add_count(c_x: torch.Tensor, c_y: torch.Tensor, s0) -> torch.Tensor:
    """Count-domain identity of the TFF adder: ``(c_x + c_y + s0) >> 1``."""
    return (c_x + c_y + s0) >> 1


# -- adder trees ---------------------------------------------------------------

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


def _pad_leaves(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero leaves along ``axis`` up to the tree's ``2 ** depth`` leaves, as
    a fixed hardware tree pads unused inputs."""
    M = x.shape[axis]
    pad = (1 << tree_depth(M)) - M
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def tff_tree_counts(counts: torch.Tensor, s0_mode: str = "alt"
                    ) -> torch.Tensor:
    """Reduce ``(..., M)`` leaf popcounts through a TFF adder tree -> ``(...,)``.

    Level ``l`` pairs nodes ``(2i, 2i+1)`` with initial state
    ``_node_s0(mode, l, i)``.
    """
    c = _pad_leaves(counts, -1)
    for level in range(tree_depth(counts.shape[-1])):
        left = c[..., 0::2]
        right = c[..., 1::2]
        idx = torch.arange(left.shape[-1], dtype=c.dtype, device=c.device)
        c = (left + right + _node_s0(s0_mode, level, idx)) >> 1
    return c[..., 0]


def tff_tree_gate(streams: torch.Tensor, length: int, s0_mode: str = "alt"
                  ) -> torch.Tensor:
    """Packed TFF adder tree on streams ``(..., M, n_words)`` -> the packed
    root stream: the proof of the count-domain tree, node by node."""
    s = _pad_leaves(streams, -2)
    for level in range(tree_depth(streams.shape[-2])):
        outs = []
        for i in range(s.shape[-2] // 2):
            s0 = int(_node_s0(s0_mode, level, torch.tensor(i)))
            z, _ = tff_add_packed(s[..., 2 * i, :], s[..., 2 * i + 1, :],
                                  length, s0=s0)
            outs.append(z)
        s = torch.stack(outs, dim=-2)
    return s[..., 0, :]


def mux_tree_counts(streams: torch.Tensor, length: int,
                    select_codes: np.ndarray) -> torch.Tensor:
    """Old-style MUX adder tree on packed streams ``(..., M, n_words)`` ->
    root popcounts.  Level ``l`` selects with the comparator stream of level
    ``N / 2`` on ``select_codes`` rolled by ``7 l + 3``, one independent
    p = 1/2 source per level, as in the conventional design."""
    s = _pad_leaves(streams, -2)
    codes = torch.as_tensor(np.asarray(select_codes), dtype=torch.int32,
                            device=streams.device)
    half = torch.tensor(length // 2, dtype=torch.int32, device=streams.device)
    for level in range(tree_depth(streams.shape[-2])):
        sel = bitstream.encode_comparator(
            half, torch.roll(codes, 7 * level + 3), length)
        s = mux_add(s[..., 0::2, :], s[..., 1::2, :], sel)
    return bitstream.popcount(s[..., 0, :])


# -- stochastic -> binary (Fig. 1d) --------------------------------------------

def counter(packed: torch.Tensor) -> torch.Tensor:
    """Stochastic-to-binary converter: count the ones."""
    return bitstream.popcount(packed)


def scaled_value(count: torch.Tensor, length: int, tree_depth: int
                 ) -> torch.Tensor:
    """A depth-``k`` tree's root count back to the unscaled sum's estimate:
    ``count * 2**k / N``."""
    return count.to(torch.float32) * (2.0 ** tree_depth) / length
