"""Stochastic number generators: code sequences and stream generation.

The code sequences are a numpy copy of ``repro.core.sng`` (bit-identical;
the tests hold them equal for every scheme at bits 2..8).  ``generate`` is
the comparator SNG, ``bit_t = codes[t] < level``, through the port's
``sng_pack`` kernel wrapper.

Schemes (paper Table 1): ``lfsr_shared``, ``lfsr_pair``, ``lowdisc`` (ramp +
van der Corput) and ``ramp_lowdisc`` (ramp + bit-reversed Gray, the
configuration the paper adopts).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Maximal-length tap masks for a left-shift Fibonacci LFSR
#   next = ((s << 1) | parity(s & mask)) & (2^k - 1)
# two distinct maximal masks per width for the two-LFSR scheme.
_LFSR_MASKS: dict[int, tuple[int, int]] = {
    2: (3, 3), 3: (5, 6), 4: (9, 12), 5: (18, 20), 6: (33, 45),
    7: (65, 68), 8: (142, 149), 9: (264, 269), 10: (516, 525),
    11: (1026, 1035), 12: (2089, 2100), 13: (4109, 4115), 14: (8213, 8220),
    15: (16385, 16392), 16: (32790, 32796),
}

SCHEMES = ("lfsr_shared", "lfsr_pair", "lowdisc", "ramp_lowdisc")


@functools.lru_cache(maxsize=64)
def lfsr_sequence(bits: int, which: int = 0, seed: int = 1,
                  length: int | None = None) -> np.ndarray:
    """Fibonacci LFSR output sequence of ``length`` k-bit states (period
    2^k-1); the state never visits 0."""
    mask = _LFSR_MASKS[bits][which]
    if length is None:
        length = 1 << bits
    state = seed & ((1 << bits) - 1)
    if state == 0:
        state = 1
    out = np.empty(length, dtype=np.int64)
    for t in range(length):
        out[t] = state
        fb = bin(state & mask).count("1") & 1
        state = ((state << 1) | fb) & ((1 << bits) - 1)
    return out


@functools.lru_cache(maxsize=32)
def vdc_sequence(bits: int) -> np.ndarray:
    """Van der Corput base-2 sequence: bit-reversed counter over 0..N-1."""
    t = np.arange(1 << bits, dtype=np.uint32)
    r = np.zeros_like(t)
    for i in range(bits):
        r |= ((t >> i) & 1) << (bits - 1 - i)
    return r.astype(np.int64)


@functools.lru_cache(maxsize=32)
def ramp_sequence(bits: int) -> np.ndarray:
    """Ramp (counter) sequence 0..N-1: thermometer-coded streams."""
    return np.arange(1 << bits, dtype=np.int64)


@functools.lru_cache(maxsize=32)
def revgray_sequence(bits: int) -> np.ndarray:
    """Bit-reversed Gray-code sequence, a low-discrepancy permutation of
    0..N-1 (the weight-side source of ``ramp_lowdisc``)."""
    t = np.arange(1 << bits, dtype=np.uint32)
    g = t ^ (t >> 1)
    r = np.zeros_like(g)
    for i in range(bits):
        r |= ((g >> i) & 1) << (bits - 1 - i)
    return r.astype(np.int64)


def codes_for_scheme(scheme: str, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """The pair of code sequences ``(codes_a, codes_b)`` for a scheme
    (activation side, weight side)."""
    if scheme == "lfsr_shared":
        seq = lfsr_sequence(bits)
        return seq, np.roll(seq, 1)
    if scheme == "lfsr_pair":
        return (lfsr_sequence(bits, which=0, seed=9),
                lfsr_sequence(bits, which=1, seed=9))
    if scheme == "lowdisc":
        return ramp_sequence(bits), vdc_sequence(bits)
    if scheme == "ramp_lowdisc":
        return ramp_sequence(bits), revgray_sequence(bits)
    raise ValueError(f"unknown SNG scheme: {scheme}")


@functools.lru_cache(maxsize=32)
def codes_tensors(scheme: str, bits: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`codes_for_scheme` as int32 tensors on ``device``, made once."""
    return tuple(torch.as_tensor(c, dtype=torch.int32, device=device)
                 for c in codes_for_scheme(scheme, bits))


def generate(level: torch.Tensor, codes: np.ndarray | torch.Tensor,
             length: int) -> torch.Tensor:
    """Comparator SNG: packed stream(s) ``(..., n_words(length))`` int32 with
    ``popcount == level`` for permutation codes, through the ``sng_pack``
    kernel wrapper."""
    from repro_torch.kernels import ops      # deferred: ops imports sng
    codes = torch.as_tensor(codes, dtype=torch.int32, device=level.device)
    return ops.sng_pack(level.to(torch.int32), codes, length)


def ramp_stream(level: torch.Tensor, length: int) -> torch.Tensor:
    """Thermometer-coded stream (the ramp-compare A2S converter model)."""
    bits = length.bit_length() - 1
    return generate(level, ramp_sequence(bits), length)


def vdc_stream(level: torch.Tensor, length: int) -> torch.Tensor:
    """Low-discrepancy (van der Corput) stream, the paper's weight source."""
    bits = length.bit_length() - 1
    return generate(level, vdc_sequence(bits), length)
