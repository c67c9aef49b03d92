"""Prompt attention: the wrappers of ``csrc/flash_attn.cu`` (the forward)
and ``csrc/flash_attn_bwd.cu`` (its backward, for training).

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

The forward also writes each row's float32 log-sum-exp where asked
(``return_lse``), which :func:`flash_attention_bwd` reads: the reference's
FA2 backward (``repro/nn/attention.py`` ``_flash_bwd``) as a ``delta =
rowsum(dout * out)`` pass, a dK/dV kernel over key tiles and a dQ kernel
over query tiles, each recomputing its score tiles, in bfloat16 on the
tensor cores (``mma.sync``, ``cp.async`` rings) and in float32 on FMAs.
Under GQA a small dK/dV grid splits each group's query heads into runs,
one per CTA (:func:`bwd_head_split_plan`, a function of the shapes alone);
each CTA writes float32 partials and a fourth launch sums them in split
order (see the source).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version :func:`repro_torch.kernels.ref.flash_attention_chunked` (forward)
or :func:`repro_torch.kernels.ref.flash_attention_bwd_chunked`
(backward).
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


def bwd_head_split_plan(B: int, Sk: int, Hkv: int, n_rep: int
                        ) -> tuple[int, int]:
    """(splits, run) of ``flash_attention_bwd``'s dK/dV launch: each
    group's ``n_rep`` query heads cut into ``splits`` runs of ``run`` whole
    heads, split s covering heads ``[s * run, min(n_rep, (s + 1) * run))``
    of the group, none empty; together they cover the group once, in
    order.  The heads are split only when the unsplit grid (key tiles of
    ``TILE_K`` x Hkv x B CTAs) is under ``MIN_CTAS``, until the grid
    reaches it or every head has a CTA of its own.  A function of the
    shapes alone."""
    ctas = -(-Sk // TILE_K) * Hkv * B
    if ctas >= MIN_CTAS or n_rep <= 1:
        return 1, n_rep
    run = max(1, n_rep // -(-MIN_CTAS // ctas))
    return -(-n_rep // run), run


def _checks(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int | None, q_offset: int, smem, **more: torch.Tensor):
    """The checks both kernels make of their inputs: dtype, shapes, D in
    whole 16-byte vectors, a 32-bit window and offset, device and
    contiguity (``more``: other tensors in q's dtype and layout), the
    shared memory ``smem(Sq, D)`` asks for, and the grid's limits.  Returns (B,
    Sq, Hq, D, Sk, Hkv, the kernel's window)."""
    dev, dt = q.device, v.dtype
    if dt not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dt}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if (k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or Hkv == 0
            or Hq % Hkv or any(t.shape != q.shape for t in more.values())):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}" + "".join(
                             f", {a} {tuple(t.shape)}"
                             for a, t in more.items()))
    if D > MAX_D or (D * v.element_size()) % 16:
        raise ValueError(f"{name} takes D <= {MAX_D} in whole 16-byte "
                         f"vectors; D={D} in {dt} is not")
    win = _window(window)
    if not 0 < win < 1 << 31 or not 0 <= q_offset < 1 << 31:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         "non-negative 32-bit integers")
    for arg, t in (("q", q), ("k", k), ("v", v), *more.items()):
        _check(arg, t, dev, dt)
    if smem(Sq, D) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: D={D} needs more shared memory than a "
                         "block has")
    if B > 65535 or Hq > 65535 or max(q.numel(), k.numel()) >= 1 << 62:
        raise ValueError(f"{name}: too large for one launch")
    return B, Sq, Hq, D, Sk, Hkv, win


@functools.cache
def _lib():
    lib = build.load("flash_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [p] * 8 + [i] * 9 + [ctypes.c_float] \
        + [i] * 4 + [p]
    lib.flash_attn_launch.restype = i
    lib.flash_attn_smem_bytes.argtypes = [i, i, i]
    lib.flash_attn_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024, return_lse: bool = False):
    """q, k, v (BH, S, D) as the TPU kernel takes them, or q (B, Sq, Hq, D)
    and k, v (B, Sk, Hkv, D) with Hq a multiple of Hkv; float32 or
    bfloat16.  Query i sits at ``q_offset + i``; ``window`` None or 0 is no
    window.  Returns q's shape in v's dtype (see
    :func:`repro_torch.kernels.ref.flash_attention_chunked`, which CPU
    tensors run in ``q_chunk`` x ``kv_chunk`` chunks; the kernel has its
    own tiles and :func:`flash_split_plan`); with ``return_lse`` (the
    4-d form only) also the rows' float32 log-sum-exp (B, Sq, Hq), the
    output's bits unchanged."""
    if q.dim() == 3:
        if return_lse:
            raise ValueError("return_lse takes the (B, S, H, D) form")
        return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window,
                               q_offset=q_offset, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)[:, :, 0]
    if not q.is_cuda:
        return ref.flash_attention_chunked(q, k, v, causal, window,
                                           q_offset, q_chunk, kv_chunk,
                                           return_lse)
    name = "flash_attention"
    dev, dt = q.device, v.dtype
    B, Sq, Hq, D, Sk, Hkv, win = _checks(
        name, q, k, v, window, q_offset,
        lambda Sq, D: _lib().flash_attn_smem_bytes(Sq, D, DTYPES[dt]))
    out = torch.empty(q.shape, dtype=dt, device=dev)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if Sk == 0:
        raise ValueError(f"{name}: no keys to attend")
    splits, split_lo, split_keys = flash_split_plan(
        B, Sq, Sk, Hq, q_offset, window, causal)
    if split_lo + splits * split_keys >= 1 << 31:
        raise ValueError(f"{name}: too large for one launch")
    _buf, acc, m, l = _scratch(splits, B * Sq * Hq, D, dev)
    with torch.cuda.device(dev):
        err = _lib().flash_attn_launch(
            *_ptrs(q, k, v, out), acc, m, l, *_ptrs(lse), B, Sq, Sk, Hq,
            Hkv, D, q_offset, win, int(causal), D ** -0.5, DTYPES[dt],
            splits, split_lo, split_keys,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attn_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_bwd_launch.argtypes = [p] * 11 + [i] * 9 + [ctypes.c_float] \
        + [i] * 3 + [p]
    lib.flash_bwd_launch.restype = i
    lib.flash_bwd_smem_bytes.argtypes = [i, i]
    lib.flash_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention`'s (B, S, H, D)
    form: q, out, dout (B, Sq, Hq, D), k, v (B, Sk, Hkv, D) in one dtype
    (float32 or bfloat16), lse (B, Sq, Hq) float32 from the forward
    (``return_lse``), and the forward's ``causal``, ``window`` and
    ``q_offset``.  Returns dq in q's layout and dk, dv in k's, in the
    inputs' dtype: the kernel on CUDA tensors (its own tiles and
    :func:`bwd_head_split_plan`), the plain version
    :func:`repro_torch.kernels.ref.flash_attention_bwd_chunked` in
    ``q_chunk`` x ``kv_chunk`` chunks on CPU tensors.  ``launches`` counts
    calls, whatever the plan: three device launches a call, four when
    the heads are split."""
    if not q.is_cuda:
        return ref.flash_attention_bwd_chunked(q, k, v, out, dout, lse,
                                               causal, window, q_offset,
                                               q_chunk, kv_chunk)
    name = "flash_attention_bwd"
    dev, dt = q.device, q.dtype
    B, Sq, Hq, D, Sk, Hkv, win = _checks(
        name, q, k, v, window, q_offset,
        lambda Sq, D: _bwd_lib().flash_bwd_smem_bytes(D, DTYPES[dt]),
        out=out, dout=dout)
    if lse.shape != (B, Sq, Hq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)}, expected "
                         f"{(B, Sq, Hq)}")
    _check("lse", lse, dev, torch.float32)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if -(-Sk // TILE_K) > 65535 or -(-Sq // TILE_K) > 65535:
        raise ValueError(f"{name}: too large for one launch")
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
    splits, run = bwd_head_split_plan(B, Sk, Hkv, Hq // Hkv)
    # float32 partial dk and dv of each split, summed by a second launch
    part = torch.empty((2, splits) + k.shape, dtype=torch.float32,
                       device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        err = _bwd_lib().flash_bwd_launch(
            *_ptrs(q, k, v, out, dout, lse, delta, dq, dk, dv, part), B, Sq,
            Sk, Hq, Hkv, D, q_offset, win, int(causal), D ** -0.5,
            DTYPES[dt], splits, run, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
