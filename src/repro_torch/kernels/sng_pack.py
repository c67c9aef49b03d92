"""Comparator SNG + bit packing: wrapper of ``csrc/sng_pack.cu``.

Replaces the TPU kernel ``repro/kernels/sng_pack.py`` ``sng_pack_pallas``.
On the H100 it is bound by bytes (4 bytes in per level, N/8 bytes out): a
stream depends only on its level, so each persistent CTA builds the (N + 1)
streams of levels 0..N once in shared memory and then copies a table row per
level in 16-byte chunks (see the source for the design).  Unlike the TPU
kernel it also takes streams shorter than 32 bits: one word with N valid low
bits, zeros above.  :func:`sng_pack_plan` is the launch plan, a function of
the shapes and the SM count that the CPU tests check.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bitstream import n_words
from repro_torch.kernels import build, ref

MAX_LENGTH = 256
THREADS = 512                 # csrc/sng_pack.cu kThreads
CHUNK_WORDS = (1, 2, 4, 8)    # words per stream with a 16-byte chunk kernel


def sng_pack_plan(n: int, length: int, sms: int, aligned: bool
                  ) -> tuple[int, int, int]:
    """(route, items, ctas) for ``n`` levels of ``length``-bit streams.
    route: the chunk kernel's words per stream (1, 2, 4, 8; it needs the
    levels 16-byte aligned), whose ``items`` are the whole 16-byte output
    chunks (the levels of a last partial chunk are stored word by word), or
    0: the level-by-level kernel.  ``ctas``: one per SM at most."""
    nw = n_words(length)
    if aligned and nw in CHUNK_WORDS:
        route = nw
        items = 2 * n if nw == 8 else n // (4 // nw)
        work = max(items, 1)
    else:
        route, items, work = 0, 0, n
    return route, items, min(sms, -(-work // THREADS))


@functools.cache
def _launch_plan(n: int, length: int, index: int, aligned: bool
                 ) -> tuple[int, int, int]:
    """:func:`sng_pack_plan` on device ``index``, made once per shape."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sng_pack_plan(n, length, sms, aligned)


@functools.cache
def _launcher():
    fn = build.load("sng_pack").sng_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sng_pack(levels: torch.Tensor, codes: torch.Tensor, length: int
             ) -> torch.Tensor:
    """levels: any shape, int32; codes: (N,) int32 on the same device.
    Returns (..., n_words(N)) int32 packed streams (uint32 bit patterns):
    bit t of word w is ``codes[32 w + t] < level``, for any int32 level.  A
    CUDA tensor launches the kernel; a CPU tensor runs
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
    route, items, ctas = _launch_plan(n, length, levels.device.index,
                                      levels.data_ptr() % 16 == 0)
    with torch.cuda.device(levels.device):
        err = _launcher()(levels.data_ptr(), codes.data_ptr(), out.data_ptr(),
                          n, length, route, items, ctas,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sng_pack kernel launch failed: CUDA error {err}")
    sng_pack.launches += 1
    return out


sng_pack.launches = 0
