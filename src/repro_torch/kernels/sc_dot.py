"""Stochastic dot product (AND + popcount + TFF tree): wrapper of
``csrc/sc_dot.cu``.

Replaces the TPU kernel ``repro/kernels/sc_dot.py`` ``sc_dot_pallas``.  On
the H100 it is bound by operations (``__popc`` issues 16 results per clock
per SM); the kernel gives one thread to each (window, output) pair, stages
X rows and W columns in shared memory so each X word is read once per block,
and folds the TFF tree as the leaves stream in, in registers (see the source
for the design).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

MODES = {"zero": 0, "one": 1, "alt": 2}
IDEAL = 3
MAX_K = 1024
MAX_WD = 8


@functools.cache
def _launcher():
    fn = build.load("sc_dot").sc_dot_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
           s0_mode: str = "alt", adder: str = "tff") -> torch.Tensor:
    """x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32 (uint32 bit
    patterns).  Returns (M, O) int32 TFF-tree root counts, or ``sum >>
    depth`` for ``adder="ideal"``.  A CUDA tensor launches the kernel, which
    needs K a power of two in [2, 1024] and Wd <= 8; a CPU tensor runs
    :func:`repro_torch.kernels.ref.sc_dot`."""
    if not x_packed.is_cuda:
        return ref.sc_dot(x_packed, w_packed, s0_mode, adder)
    if adder == "ideal":
        mode = IDEAL
    elif adder == "tff" and s0_mode in MODES:
        mode = MODES[s0_mode]
    else:
        raise ValueError(f"unknown adder/s0_mode {adder!r}/{s0_mode!r}")
    if w_packed.device != x_packed.device:
        raise ValueError("x_packed and w_packed must be on the same device")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError("sc_dot takes int32 packed words")
    if not (x_packed.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("sc_dot takes contiguous tensors")
    M, K, Wd = x_packed.shape
    K2, O, Wd2 = w_packed.shape
    if K2 != K or Wd2 != Wd:
        raise ValueError(f"shape mismatch: x {tuple(x_packed.shape)}, "
                         f"w {tuple(w_packed.shape)}")
    if K < 2 or K & (K - 1) or K > MAX_K or not 1 <= Wd <= MAX_WD:
        raise ValueError(f"sc_dot kernel needs K a power of two in [2, "
                         f"{MAX_K}] and 1 <= Wd <= {MAX_WD}; got K={K}, "
                         f"Wd={Wd}")
    if M * max(K * Wd, O) >= 1 << 31:
        raise ValueError("sc_dot: operands too large for one launch")
    out = torch.empty((M, O), dtype=torch.int32, device=x_packed.device)
    if M == 0 or O == 0:
        return out
    with torch.cuda.device(x_packed.device):
        err = _launcher()(x_packed.data_ptr(), w_packed.data_ptr(),
                          out.data_ptr(), M, K, O, Wd, mode,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_dot kernel launch failed: CUDA error {err}")
    sc_dot.launches += 1
    return out


sc_dot.launches = 0
