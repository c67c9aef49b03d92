"""Prompt attention: the wrapper of ``csrc/flash_attn.cu``.

``flash_attention`` replaces the TPU kernel of the same name in
``repro/kernels/flash_attn.py`` (causal or full attention over (BH, S, D))
and also takes the form the reference's prefill computes in XLA
(``repro/nn/attention.py`` ``_flash``): q (B, Sq, Hq, D) at an absolute
offset into k, v (B, Sk, Hkv, D), a sliding window and GQA by index.  One
kernel serves both: a (BH, S, D) call is B = BH with one head.

Bound on the H100: even between bytes and bf16 tensor-core operations at a
1,000-token prompt, bytes at a fold chunk.  In bfloat16 the kernel runs
on the tensor cores (``mma.sync`` m16n8k16, K and V tiles through a
``cp.async`` ring); in float32 on FMAs (TF32 would break the float32
contract).  When the grid is small (the fold's 16-query chunk has one CTA
per head) the key band is split into runs of whole 64-key tiles, one per
CTA (:func:`flash_split_plan`, a function of the shapes alone, so chunk j
of a cold and of a resumed fold launch the same plan); each CTA writes a
float32 partial state and a second launch merges the splits in order and
normalizes.  See the source for the design.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version :func:`repro_torch.kernels.ref.flash_attention_chunked`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_attn import (DTYPES, MAX_SMEM_BYTES, MIN_CTAS,
                                            _check, _ptrs, _raise_on,
                                            _scratch, _window)

MAX_D = 128
TILE_K = 64                # keys per tile of the kernel


def tile_q(Sq: int) -> int:
    """Queries per CTA: 16 for a fold chunk (Sq <= 16), else 64."""
    return 16 if Sq <= 16 else 64


def flash_split_plan(B: int, Sq: int, Sk: int, Hq: int, q_offset: int,
                     window: int | None, causal: bool = True
                     ) -> tuple[int, int, int]:
    """(splits, split_lo, split_keys) of ``flash_attention``: the key band
    of the call, ``[split_lo, k_hi)`` with ``split_lo = max(0, q_offset -
    win + 1)`` and ``k_hi = min(Sk, q_offset + Sq)`` (causal) or ``Sk``,
    cut into ``splits`` runs of ``split_keys`` keys (whole tiles of
    ``TILE_K``), split z covering ``[split_lo + z * split_keys, ... +
    split_keys)``; together they cover the band exactly once.  The band
    is split only when (query tiles x Hq x B) is under ``MIN_CTAS``, into
    about ``MIN_CTAS`` CTAs.  A function of the shapes alone."""
    win = _window(window)
    k_lo = max(0, q_offset - win + 1)
    k_hi = min(Sk, q_offset + Sq) if causal else Sk
    n_tiles = max(1, -(-(k_hi - k_lo) // TILE_K))
    ctas = -(-Sq // tile_q(Sq)) * Hq * B
    want = -(-MIN_CTAS // ctas) if ctas < MIN_CTAS else 1
    tiles_per_split = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // tiles_per_split), k_lo, tiles_per_split * TILE_K


@functools.cache
def _lib():
    lib = build.load("flash_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float] \
        + [i] * 4 + [p]
    lib.flash_attn_launch.restype = i
    lib.flash_attn_smem_bytes.argtypes = [i, i, i]
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
    own tiles and :func:`flash_split_plan`)."""
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
    if _lib().flash_attn_smem_bytes(Sq, D, DTYPES[dt]) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: D={D} needs more shared memory than a "
                         "block has")
    if B > 65535 or Hq > 65535 or max(q.numel(), k.numel()) >= 1 << 62:
        raise ValueError(f"{name}: too large for one launch")
    out = torch.empty(q.shape, dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{name}: no keys to attend")
    splits, split_lo, split_keys = flash_split_plan(
        B, Sq, Sk, Hq, q_offset, window, causal)
    if split_lo + splits * split_keys >= 1 << 31:
        raise ValueError(f"{name}: too large for one launch")
    _buf, acc, m, l = _scratch(splits, B * Sq * Hq, D, dev)
    with torch.cuda.device(dev):
        err = _lib().flash_attn_launch(
            *_ptrs(q, k, v, out), acc, m, l, B, Sq, Sk, Hq, Hkv, D, q_offset,
            win, int(causal), D ** -0.5, DTYPES[dt], splits, split_lo,
            split_keys, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
