"""The wrappers the SC layer calls: K padding, the level -> stream -> dot
composition, and the fused pos/neg dot product.

There is no interpret flag: the device of the tensors decides.  A CUDA
tensor goes through the hand-written kernels (``sng_pack.cu``, ``sc_dot.cu``)
or raises; a CPU tensor goes through their plain versions in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core import sng
from repro_torch.core.arith import tree_depth
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel

BITS = range(2, 9)          # supported precisions: N = 4 .. 256


def _next_pow2(k: int) -> int:
    return 1 << tree_depth(k)


def _pad_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to ``size`` (zero streams)."""
    if x.shape[axis] == size:
        return x.contiguous()
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor, *,
           s0_mode: str = "alt", adder: str = "tff") -> torch.Tensor:
    """Stochastic dot product on packed streams.

    x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32.
    Returns (M, O) int32 TFF-tree root counts.  K is zero-padded to the next
    power of two: all-zero streams are exactly the fixed tree's unused
    leaves, so the result is bit-identical to a tree over K leaves.
    """
    Kp = _next_pow2(x_packed.shape[1])
    return sc_dot_kernel.sc_dot(_pad_axis(x_packed, 1, Kp),
                                _pad_axis(w_packed, 0, Kp), s0_mode, adder)


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """Comparator SNG + packing.  levels: any shape, int32 in [0, N];
    codes: (N,) int32; N = 2**bits with bits in 2..8.
    Returns (..., max(1, N//32)) int32 packed streams."""
    if length not in [1 << b for b in BITS]:
        raise ValueError(f"stream length {length} is not 2**bits, bits 2..8")
    return sng_pack_kernel.sng_pack(levels.contiguous(), codes.contiguous(),
                                    length)


def sc_dot_from_levels(x_lvl: torch.Tensor, w_lvl: torch.Tensor, bits: int, *,
                       scheme: str = "ramp_lowdisc", s0_mode: str = "alt",
                       adder: str = "tff") -> torch.Tensor:
    """Full SC datapath from integer levels: SNG pack -> dot, both kernels.

    x_lvl: (M, K) int32 levels 0..N;  w_lvl: (K, O) int32 levels.
    """
    N = 1 << bits
    codes_a, codes_b = sng.codes_tensors(scheme, bits, x_lvl.device)
    return sc_dot(sng_pack(x_lvl, codes_a, N), sng_pack(w_lvl, codes_b, N),
                  s0_mode=s0_mode, adder=adder)


def sc_dot_posneg(x_packed: torch.Tensor, w_pos: torch.Tensor,
                  w_neg: torch.Tensor, **kw) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Both halves of the split-weight design in one kernel call: the two
    weight banks are concatenated along O, so every X word is read once
    for ``x∘w_pos`` and ``x∘w_neg``.

    Returns (counts_pos, counts_neg), each (M, O) int32.
    """
    O = w_pos.shape[1]
    out = sc_dot(x_packed, torch.cat([w_pos, w_neg], dim=1), **kw)
    return out[:, :O], out[:, O:]
