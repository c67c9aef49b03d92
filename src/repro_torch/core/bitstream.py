"""Packed stochastic bit-stream layout (the part of ``repro.core.bitstream``
the SC frame path needs).

A stream of ``N`` bits is stored as ``n_words(N)`` 32-bit words, LSB first:
bit ``t`` lives in word ``t // 32`` at position ``t % 32``.  For ``N < 32``
the single word carries ``N`` valid low bits and zeros above them.

The port holds packed words in ``torch.int32`` tensors as uint32 bit
patterns: PyTorch's CPU build lacks ``>>``, ``-`` and ``<`` on
``torch.uint32``, while the CUDA kernels simply read the words as
``uint32_t``.  Compare with numpy/JAX through ``.view(np.uint32)``.
"""
from __future__ import annotations

WORD = 32


def n_words(length: int) -> int:
    """Number of 32-bit words needed for a stream of ``length`` bits."""
    return (int(length) + WORD - 1) // WORD
