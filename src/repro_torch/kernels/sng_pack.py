"""Comparator SNG + bit packing: wrapper of ``csrc/sng_pack.cu``.

Replaces the TPU kernel ``repro/kernels/sng_pack.py`` ``sng_pack_pallas``.
On the H100 it is bound by memory (4 bytes in per level, N/8 bytes out); the
kernel gives one thread to each output word and keeps the codes in shared
memory (see the source for the design).  Unlike the TPU kernel it also takes
streams shorter than 32 bits: one word with N valid low bits, zeros above.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bitstream import n_words
from repro_torch.kernels import build, ref

MAX_LENGTH = 256


@functools.cache
def _launcher():
    fn = build.load("sng_pack").sng_pack_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """levels: any shape, int32 in [0, N]; codes: (N,) int32 on the same
    device.  Returns (..., n_words(N)) int32 packed streams (uint32 bit
    patterns).  A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`repro_torch.kernels.ref.sng_pack`."""
    if not levels.is_cuda:
        return ref.sng_pack(levels, codes, length)
    if codes.device != levels.device:
        raise ValueError("levels and codes must be on the same device")
    if levels.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("sng_pack takes int32 levels and codes")
    if not (levels.is_contiguous() and codes.is_contiguous()):
        raise ValueError("sng_pack takes contiguous tensors")
    if not 1 <= length <= MAX_LENGTH or codes.shape != (length,):
        raise ValueError(f"sng_pack needs 1 <= length <= {MAX_LENGTH} and "
                         f"codes of shape ({length},), got {tuple(codes.shape)}")
    n = levels.numel()
    if n * n_words(length) >= 1 << 31:
        raise ValueError("sng_pack: too many levels for one launch")
    out = torch.empty(levels.shape + (n_words(length),), dtype=torch.int32,
                      device=levels.device)
    if n == 0:
        return out
    with torch.cuda.device(levels.device):
        err = _launcher()(levels.data_ptr(), codes.data_ptr(), out.data_ptr(),
                          n, length, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sng_pack kernel launch failed: CUDA error {err}")
    sng_pack.launches += 1
    return out


sng_pack.launches = 0
