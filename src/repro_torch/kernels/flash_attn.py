"""Prompt attention: the wrapper of ``csrc/flash_attn.cu``.

``flash_attention`` replaces the TPU kernel of the same name in
``repro/kernels/flash_attn.py`` (causal or full attention over (BH, S, D))
and also takes the form the reference's prefill computes in XLA
(``repro/nn/attention.py`` ``_flash``): q (B, Sq, Hq, D) at an absolute
offset into k, v (B, Sk, Hkv, D), a sliding window and GQA by index.  One
kernel serves both: a (BH, S, D) call is B = BH with one head.

Bound on the H100: even between bytes and bf16 tensor-core operations at a
1,000-token prompt, bytes at a fold chunk (see the source for the design).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version :func:`repro_torch.kernels.ref.flash_attention_chunked`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attn import (DTYPES, MAX_SMEM_BYTES, _check,
                                            _raise_on, _window)

MAX_D = 128


@functools.cache
def _lib():
    lib = build.load("flash_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [p] * 4 + [i] * 9 + [ctypes.c_float, i,
                                                          p]
    lib.flash_attn_launch.restype = i
    lib.flash_attn_smem_bytes.argtypes = [i, i]
    lib.flash_attn_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q, k, v (BH, S, D) as the TPU kernel takes them, or q (B, Sq, Hq, D)
    and k, v (B, Sk, Hkv, D) with Hq a multiple of Hkv; float32 or
    bfloat16.  Query i sits at ``q_offset + i``; ``window`` None or 0 is no
    window.  Returns q's shape in v's dtype (see
    :func:`repro_torch.kernels.ref.flash_attention_chunked`, which CPU
    tensors run in ``q_chunk`` x ``kv_chunk`` chunks; the kernel has its
    own tiles)."""
    if q.dim() == 3:
        return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window,
                               q_offset=q_offset, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)[:, :, 0]
    if not q.is_cuda:
        return ref.flash_attention_chunked(q, k, v, causal, window,
                                           q_offset, q_chunk, kv_chunk)
    name = "flash_attention"
    dev, dt = q.device, v.dtype
    if dt not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dt}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if (k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_D or (D * v.element_size()) % 16:
        raise ValueError(f"{name} takes D <= {MAX_D} in whole 16-byte "
                         f"vectors; D={D} in {dt} is not")
    win = _window(window)
    if not 0 < win < 1 << 31 or not 0 <= q_offset < 1 << 31:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         "non-negative 32-bit integers")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check(arg, t, dev, dt)
    if _lib().flash_attn_smem_bytes(Sq, D) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: D={D} needs more shared memory than a "
                         "block has")
    if B > 65535 or Hq > 65535 or max(q.numel(), k.numel()) >= 1 << 62:
        raise ValueError(f"{name}: too large for one launch")
    out = torch.empty(q.shape, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{name}: no keys to attend")
    with torch.cuda.device(dev):
        err = _lib().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, D, q_offset, win, int(causal), D ** -0.5,
            DTYPES[dt], torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
