"""The wrappers the SC layer calls: the level -> stream -> dot composition
and the fused pos/neg dot product.

There is no interpret flag: the device of the tensors decides.  A CUDA
tensor goes through the hand-written kernels (``sng_pack.cu``, ``sc_dot.cu``)
or raises; a CPU tensor goes through their plain versions in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core import sng
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel

BITS = range(2, 9)          # supported precisions: N = 4 .. 256


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor, *,
           s0_mode: str = "alt", adder: str = "tff",
           length: int | None = None) -> torch.Tensor:
    """Stochastic dot product on packed streams.

    x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32.
    Returns (M, O) int32 TFF-tree root counts.  K need not be a power of
    two: the tree's leaves past K are zero streams, exactly the fixed tree's
    unused leaves, so nothing is padded here.  ``length`` is a contract on
    the words, not checked: they are packed streams of N = ``length`` bits,
    as :func:`sng_pack` writes them, with every bit at and above N zero.
    The kernel then pairs leaves per popcount at N <= 16; words with stray
    high bits give wrong counts.  Leave it None for any other words.
    """
    return sc_dot_kernel.sc_dot(x_packed.contiguous(), w_packed.contiguous(),
                                s0_mode, adder, length=length)


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
                  s0_mode=s0_mode, adder=adder, length=N)


def sc_dot_posneg(x_packed: torch.Tensor, w_banks: torch.Tensor, *,
                  s0_mode: str = "alt", adder: str = "tff",
                  length: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both halves of the split-weight design in one kernel launch.

    w_banks: (K, 2 O, Wd), the positive bank's O columns then the negative
    bank's, as the SC layer makes them in one ``sng_pack``; every X word is
    read once for ``x∘w_pos`` and ``x∘w_neg``.  ``length``: as for
    :func:`sc_dot`, the same contract.
    Returns (counts_pos, counts_neg), each (M, O) int32 (views of one
    (M, 2 O) result).
    """
    if w_banks.shape[1] % 2:
        raise ValueError(f"w_banks has {w_banks.shape[1]} columns: two banks "
                         "of O each")
    O = w_banks.shape[1] // 2
    out = sc_dot(x_packed, w_banks, s0_mode=s0_mode, adder=adder,
                 length=length)
    return out[:, :O], out[:, O:]
