"""Packed stochastic bit-stream layout and its plain operations.

A stream of ``N`` bits is stored as ``n_words(N)`` 32-bit words, LSB first:
bit ``t`` lives in word ``t // 32`` at position ``t % 32``.  For ``N < 32``
the single word carries ``N`` valid low bits and zeros above them.  The
unipolar value of a stream is ``popcount / N``.

The port holds packed words in ``torch.int32`` tensors as uint32 bit
patterns: PyTorch's CPU build lacks ``>>``, ``-`` and ``<`` on
``torch.uint32``, while the CUDA kernels simply read the words as
``uint32_t``.  So a word mask is an int32 (``0xFFFFFFFF`` is ``-1``), and
``>>`` on a word is arithmetic: mask after shifting right.  Compare with
numpy/JAX through ``.view(np.uint32)``.

Everything here is plain PyTorch on the device of its inputs; the
functions that make streams from no input (``word_masks``, ``zeros``,
``ones``) take ``device`` (default ``"cuda"``, raising without a card).  The
kernel wrapper of the comparator SNG is ``repro_torch.core.sng.generate``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

WORD = 32


def n_words(length: int) -> int:
    """Number of 32-bit words needed for a stream of ``length`` bits."""
    return (int(length) + WORD - 1) // WORD


def tail_mask(length: int) -> int:
    """Mask of the valid bits in the final word (an int32 bit pattern)."""
    rem = int(length) % WORD
    return -1 if rem == 0 else (1 << rem) - 1


def word_masks(length: int, device: torch.device | str = "cuda"
               ) -> torch.Tensor:
    """(n_words,) int32 validity mask of each word of the stream."""
    masks = torch.full((n_words(length),), -1, dtype=torch.int32,
                       device=resolve_device(device))
    masks[-1] = tail_mask(length)
    return masks


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean/0-1 tensor ``(..., N)`` into ``(..., n_words(N))``
    int32 words, bit ``t`` -> word ``t // 32``, position ``t % 32``.  The
    int32 sum of distinct powers of two never overflows (bit 31 is -2**31).
    """
    N = bits.shape[-1]
    w = n_words(N)
    bits = bits.to(torch.int32)
    if N > WORD and w * WORD > N:          # a partial last word of several
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] +
                                               (w * WORD - N,))], dim=-1)
    width = min(N, WORD)
    shifts = torch.arange(width, dtype=torch.int32, device=bits.device)
    return (bits.reshape(bits.shape[:-1] + (w, width)) << shifts).sum(
        -1, dtype=torch.int32)


def unpack_bits(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Unpack ``(..., n_words)`` int32 words into bool ``(..., length)``
    (bit extraction needs no mask: ``& 1`` drops the sign's copies)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * WORD,))
    return bits[..., :length].to(torch.bool)


def popcount_per_word(packed: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count, int32, same shape as ``packed``."""
    from repro_torch.kernels.ref import popcount32       # ref imports this
    return popcount32(packed)


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Total set bits over the trailing word axis -> int32 ``(...)``."""
    return popcount_per_word(packed).sum(-1, dtype=torch.int32)


def encode_comparator(level: torch.Tensor, codes: torch.Tensor, length: int
                      ) -> torch.Tensor:
    """Comparator SNG (Fig. 1c): ``bit_t = codes[t] < level``, packed.

    level: integer tensor ``(...)``; codes: ``(length,)`` integer codes on
    the same device.  Returns ``(..., n_words(length))`` int32 words.
    """
    bits = codes[None, :] < level.reshape(-1, 1)
    return pack_bits(bits).reshape(level.shape + (n_words(length),))


def value(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Unipolar value ``popcount / N`` as float32."""
    return popcount(packed).to(torch.float32) / length


def zeros(shape: tuple, length: int, device: torch.device | str = "cuda"
          ) -> torch.Tensor:
    """All-zero stream(s) (unipolar value 0)."""
    return torch.zeros(tuple(shape) + (n_words(length),), dtype=torch.int32,
                       device=resolve_device(device))


def ones(shape: tuple, length: int, device: torch.device | str = "cuda"
         ) -> torch.Tensor:
    """All-one stream(s) (unipolar value 1); tail bits beyond N stay zero."""
    return word_masks(length, device).expand(tuple(shape) +
                                             (n_words(length),))
