"""Plain PyTorch versions of the CUDA kernels, with the kernels' signatures.

They run on the CPU (the wrappers use them for CPU tensors) and on the card
(``chip_smoke.py`` holds each kernel bitwise against them there).  Packed
words are ``torch.int32`` tensors holding uint32 bit patterns; the bit
arithmetic runs in int64 on the masked patterns, because PyTorch has no
``>>``, ``-`` or ``<`` for ``torch.uint32`` on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import arith
from repro_torch.core.bitstream import WORD, n_words

_U32 = 0xFFFFFFFF
# elements of the (rows, K, O, Wd) AND product materialized at once
_CHUNK_ELEMS = 1 << 24


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR in int64) -> int64."""
    v = v.to(torch.int64) & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """Comparator SNG + LSB-first packing.

    levels: any shape, int32 in [0, N]; codes: (N,) int32.  Returns
    (..., n_words(N)) int32: bit t of word w is ``codes[32w+t] < level``;
    for N < 32 the bits above N are 0.
    """
    nw = n_words(length)
    bits = (codes[None, :length] < levels.reshape(-1, 1)).to(torch.int64)
    pad = nw * WORD - length
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[0], pad)], dim=1)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD, dtype=torch.int64, device=bits.device)
    packed = (bits.reshape(-1, nw, WORD) * weights).sum(-1)
    return to_int32_bits(packed).reshape(levels.shape + (nw,))


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
           s0_mode: str = "alt", adder: str = "tff") -> torch.Tensor:
    """AND + popcount over the words, then the TFF tree over K.

    x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32.
    Returns (M, O) int32 root counts.  K is padded to a power of two with
    zero leaves; ``adder="ideal"`` returns ``sum >> depth`` instead.
    """
    M, K, Wd = x_packed.shape
    O = w_packed.shape[1]
    rows = max(1, _CHUNK_ELEMS // max(1, K * O * Wd))
    counts = torch.cat([                                  # (M, K, O)
        popcount32(x_packed[i:i + rows, :, None, :] & w_packed[None]).sum(-1)
        for i in range(0, M, rows)])
    if adder == "ideal":
        return (counts.sum(1) >> arith.tree_depth(K)).to(torch.int32)
    if adder != "tff":
        raise ValueError(f"unknown adder {adder!r}")
    return arith.tff_tree_counts(counts.transpose(1, 2), s0_mode
                                 ).to(torch.int32)
